"""Fused APGD-Linf update: the CUDA kernel and its plain version.

Port of ``robseg_tpu/kernels/apgd_step.py::apgd_linf_step_pallas``; the
kernel is ``robseg_torch/csrc/apgd_step.cu``.

    z      = clip01(clamp_{x +- eps}(x_adv + step * sign(grad)))
    x_next = clip01(clamp_{x +- eps}(x_adv + (z - x_adv) * a
                                     + (x_adv - x_old) * (1 - a)))

``step`` is per image, ``eps`` and ``a`` are scalars. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, and anything the kernel
does not take raises.
"""

from __future__ import annotations

import torch

from robseg_torch.kernels import _build
from robseg_torch.ops.projections import project_linf


def apgd_linf_step_plain(x, x_adv, x_old, grad, step, eps: float, a: float):
    """The step in PyTorch ops, in the order of the JAX APGD core
    (``robseg_tpu/attacks/apgd.py:371-375``)."""
    step = step.reshape((step.shape[0],) + (1,) * (x.ndim - 1))
    grad2 = x_adv - x_old
    z = project_linf(x_adv + step * torch.sign(grad), x, eps)
    return project_linf(x_adv + (z - x_adv) * a + grad2 * (1.0 - a), x, eps)


def apgd_linf_step_cuda(x, x_adv, x_old, grad, step, eps: float, a: float):
    """Launch the kernel; all tensors f32, contiguous, on one CUDA device."""
    if not x.is_cuda:
        raise ValueError(f"apgd_linf_step_cuda: x is on {x.device}, not CUDA")
    b = x.shape[0]
    for name, t in (("x", x), ("x_adv", x_adv), ("x_old", x_old),
                    ("grad", grad)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != x.shape or not t.is_contiguous()):
            raise ValueError(
                f"apgd_linf_step: {name} must be a contiguous float32 "
                f"tensor of shape {tuple(x.shape)} on {x.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (step.device != x.device or step.dtype != torch.float32
            or step.numel() != b):
        raise ValueError("apgd_linf_step: step must hold one float32 value "
                         "per image on the same device")
    step = step.reshape(b).contiguous()
    out = torch.empty_like(x)
    per_image = x.numel() // b
    _build.launch(
        x.device, _build.library().robseg_apgd_linf_step, x.data_ptr(),
        x_adv.data_ptr(), x_old.data_ptr(), grad.data_ptr(), step.data_ptr(),
        out.data_ptr(), b, per_image, float(eps), float(a), 1.0 - float(a),
        name="apgd_linf_step")
    apgd_linf_step_cuda.launches += 1
    return out


apgd_linf_step_cuda.launches = 0


def apgd_linf_step(x, x_adv, x_old, grad, step, eps: float, a: float):
    """One Linf APGD update; the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return apgd_linf_step_cuda(x, x_adv, x_old, grad, step, eps, a)
    return apgd_linf_step_plain(x, x_adv, x_old, grad, step, eps, a)
