"""Sign-PGD used to make the adversarial examples of PIR-AT training, and
its random-start variant.

Port of ``robseg_tpu/attacks/pgd.py`` (reference ``semseg/val.py:130-218``,
``Pgd_Attack`` and ``Pgd_Attack_1``), a Python loop over the steps. The
gradient is taken with respect to the perturbation only
(``torch.autograd.grad(loss, delta)``), so no parameter's ``.grad`` is
touched. Reproduced quirks:

  * ``pgd_attack`` picks each image's best step by its loss *before* the
    step but stores the delta *after* it (``val.py:158-175``); with the
    scalar ``pgd`` loss every image shares one decision;
  * ``pgd_attack`` clips ``x + delta`` inside the forward,
    ``pgd_attack_rs`` does not;
  * ``l2-loss`` broadcasts the labels against channels-last logits, as
    the JAX expression does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from robseg_torch.ops.losses import (cross_entropy_pixelwise, js_loss,
                                     segmentation_cross_entropy)


def _pgd_scalar_ce(logits, y):
    """``losses['pgd'] = F.cross_entropy(x, y)``: the scalar mean CE."""
    return segmentation_cross_entropy(logits, y, -1)


def _mask_ce_avg(logits, y):
    """CE on the pixels classified correctly, mean over all pixels of each
    image (``val.py:112-118``)."""
    mask = (logits.argmax(1) == y).to(logits.dtype)
    loss = cross_entropy_pixelwise(logits, y, None, ignore_index=-1)
    return (mask * loss).reshape(logits.shape[0], -1).mean(-1)


def _js_avg(logits, y):
    return js_loss(logits, y, ignore_index=-1).reshape(
        logits.shape[0], -1).mean(-1)


def _l2_loss(logits, y):
    lg = logits.permute(0, 2, 3, 1)  # the JAX expression's layout
    return ((lg - y) ** 2).reshape(lg.shape[0], -1).sum(-1)


def segpgd_loss(logits, y, t, total_iters, ignore_index: int = -1):
    """SegPGD loss (Gu et al., ECCV 2022): per-pixel CE weighted 1 - lambda
    on correctly classified pixels and lambda on the others, lambda =
    t / (2 T); the mean over each image's pixels."""
    lam = t / (2.0 * total_iters)
    correct = (logits.argmax(1) == y).to(logits.dtype)
    ce = cross_entropy_pixelwise(logits, y, None, ignore_index)
    w = (1.0 - lam) * correct + lam * (1.0 - correct)
    return (w * ce).reshape(logits.shape[0], -1).mean(-1)


TRAIN_ATTACK_LOSSES = {
    "pgd": _pgd_scalar_ce,
    "mask-ce-avg": _mask_ce_avg,
    "js-avg": _js_avg,
    "l2-loss": _l2_loss,
    # segpgd-loss needs the step index; pgd_attack handles it
}


def pgd_attack(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
               eps: float = 4.0 / 255.0, alpha: float = 1e-2,
               num_iter: int = 2, loss: str = "pgd") -> torch.Tensor:
    """``Pgd_Attack.adv_attack``: no random start, best-loss delta tracking;
    returns ``x_adv`` (detached). ``x`` (B, 3, H, W) in [0, 1]."""
    if loss == "segpgd-loss":
        loss_fn = lambda lg, yy, t: segpgd_loss(lg, yy, t, num_iter)  # noqa
    else:
        base = TRAIN_ATTACK_LOSSES[loss]
        loss_fn = lambda lg, yy, t: base(lg, yy)  # noqa: E731
    x = x.detach()
    bs = x.shape[0]
    delta = torch.zeros_like(x)
    best_delta = torch.zeros_like(x)
    running_best = None  # zeros in the loss's dtype
    for t in range(num_iter):
        d = delta.requires_grad_(True)
        per_img = loss_fn(logits_fn(torch.clamp(x + d, 0.0, 1.0)), y,
                          float(t))
        g, = torch.autograd.grad(per_img.sum(), d)
        per_img = per_img.detach().broadcast_to((bs,))
        if running_best is None:
            running_best = torch.zeros_like(per_img)
        ind = per_img >= running_best
        running_best = torch.where(ind, per_img, running_best)
        delta = delta.detach() + alpha * torch.sign(g)
        delta = torch.clamp(x + delta, 0.0, 1.0) - x
        delta = torch.clamp(delta, -eps, eps)
        best_delta = torch.where(ind.reshape((bs,) + (1,) * (x.ndim - 1)),
                                 delta, best_delta)
    return torch.clamp(x + best_delta, 0.0, 1.0)


def pgd_attack_rs(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                  eps: float = 4.0 / 255.0, alpha: float = 1e-2,
                  num_iter: int = 2, loss: str = "pgd",
                  generator: Optional[torch.Generator] = None,
                  delta_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Pgd_Attack_1.adv_attack``: a uniform random start in the eps ball
    drawn from ``generator`` (``delta_init`` overrides it), no clip inside
    the forward; returns the final point, not the best."""
    loss_fn = TRAIN_ATTACK_LOSSES[loss]
    x = x.detach()
    if delta_init is not None:
        delta = delta_init.detach().to(x)
    else:
        delta = torch.empty_like(x).uniform_(-eps, eps, generator=generator)
    for _ in range(num_iter):
        d = delta.requires_grad_(True)
        g, = torch.autograd.grad(loss_fn(logits_fn(x + d), y).sum(), d)
        delta = delta.detach() + alpha * torch.sign(g)
        delta = torch.clamp(x + delta, 0.0, 1.0) - x
        delta = torch.clamp(delta, -eps, eps)
    return torch.clamp(x + delta, 0.0, 1.0)
