"""PGD over per-class convolution filters (research attack).

Port of ``robseg_tpu/attacks/filters.py::pgd_filters`` (reference
``semseg/attacker.py:731-773``): one 3x3 filter per class; each image is
convolved, the same filter on each RGB channel with zero padding, by the
filter of its class, and divided by its largest absolute value; the
filters follow the L2-normalised gradient of the attack loss minus
``alpha_reg`` times their L1 norm, clipped to [0, 1]. All images are
convolved in one grouped convolution. Gradients come from
``torch.autograd.grad`` with respect to the filters only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from robseg_torch.ops.losses import ATTACK_CRITERIA, pixel_to_img_loss


def _apply_filters(x: torch.Tensor, f: torch.Tensor,
                   y_img: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W); f (n_cls, 3, 3); y_img (B,) the class of each
    image."""
    b, c, h, w = x.shape
    kern = f[y_img].repeat_interleave(c, 0)[:, None]  # (B*3, 1, 3, 3)
    out = F.conv2d(x.reshape(1, b * c, h, w), kern, padding=1,
                   groups=b * c).reshape(b, c, h, w)
    denom = out.abs().reshape(b, -1).amax(-1)
    return out / denom.reshape(-1, 1, 1, 1)


def pgd_filters(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                y_img: torch.Tensor, *, n_iter: int = 10, alpha: float = 0.2,
                loss: str = "ce", n_cls: int = 10, alpha_reg: float = 0.0,
                generator: Optional[torch.Generator] = None,
                init_f: Optional[torch.Tensor] = None):
    """Returns ``(x_filtered, filters)``. ``y_img`` (B,): the class that
    picks each image's filter (the reference's classification-style
    ``y``). ``init_f``: the starting ``(n_cls, 3, 3)`` filter bank, else
    uniform draws from ``generator``.

    As in the reference, the returned image is built from the filters
    *before* their last update, the filters after it; and ``|f|`` in the
    regulariser has a zero subgradient at 0 (torch's ``abs``)."""
    criterion = ATTACK_CRITERIA[loss]
    if init_f is not None:
        f = init_f.to(device=x.device, dtype=x.dtype)
    else:
        f = torch.rand((n_cls, 3, 3), generator=generator, device=x.device,
                       dtype=x.dtype)

    def loss_fn(f):
        out = logits_fn(_apply_filters(x, f, y_img))
        li = pixel_to_img_loss(criterion(out, y, None))
        reg = f.abs().reshape(n_cls, -1).sum(-1).mean()
        return li.mean() - alpha_reg * reg

    f_used = f
    for _ in range(n_iter):
        f_used = f.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(f_used), f_used)
        gn = torch.sqrt((g.reshape(n_cls, -1) ** 2).sum(-1) + 1e-24)
        f = torch.clamp(f_used.detach() + alpha * g / gn.reshape(-1, 1, 1),
                        0.0, 1.0)
    with torch.no_grad():
        return _apply_filters(x, f_used.detach(), y_img), f
