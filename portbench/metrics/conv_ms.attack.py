"""conv_ms.attack: device ms per attack iteration (model call) of cuDNN's
convolution kernels, by chip_smoke.py's kernel classifier
(``portbench.trace.kernel_kind``)."""

from portbench.trace import kernel_kind

KIND = "convolution (cuDNN)"


def read(obs):
    if not obs.ops or not obs.units:
        return None
    return obs.device_ms(lambda op: kernel_kind(op.name) == KIND) / obs.units
