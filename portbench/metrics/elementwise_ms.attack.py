"""elementwise_ms.attack: device ms per attack iteration (model call) of
PyTorch's elementwise, norm, resize and loss kernels, by chip_smoke.py's
kernel classifier (``portbench.trace.kernel_kind``)."""

from portbench.trace import kernel_kind

KIND = "elementwise, norms, resize, loss"


def read(obs):
    if not obs.ops or not obs.units:
        return None
    return obs.device_ms(lambda op: kernel_kind(op.name) == KIND) / obs.units
