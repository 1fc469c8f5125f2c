"""Attack criteria and training losses on NCHW logits.

Port of ``robseg_tpu/ops/losses.py``: the attack criteria
(``ATTACK_CRITERIA``, ``:200-207``, with ``ce-targeted``), the other
pixelwise attack losses (``margin_loss``, ``dlr_loss``,
``dlr_loss_targeted``, ``targeted_cross_entropy``, ``js_div_pixelwise``;
``:111-197``) and the training losses
(``segmentation_cross_entropy``, ``ohem_cross_entropy``, ``dice_loss``,
``get_train_loss``; ``:222-298``). The conventions that define the SEA
attacks carry over exactly:

  * logits are ``(B, K, H, W)``; labels ``(B, H, W)`` int, ignore ``-1``;
  * pixelwise criteria return ``(B, H, W)`` with zeros at ignored pixels;
    ignored labels are folded to class 0 before any lookup (``:61-66``,
    ``:119-127``);
  * the Mask-CE masks are detached from the graph (``:80``, ``:93``);
  * ``pixel_to_img_loss`` averages over all H*W pixels, ignored included.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

# Smallest normal float32 (``losses.py:108``): clamping the JS mixture's log
# argument here only acts where softmax saturates to exact zeros, and keeps
# the attack gradient finite there.
_TINY = 1.1754944e-38


def cross_entropy_pixelwise(logits: torch.Tensor, target: torch.Tensor,
                            weights: Optional[torch.Tensor] = None,
                            ignore_index: int = -1) -> torch.Tensor:
    """Per-pixel CE ``-w[y] log p_y``, zero at ignored pixels."""
    valid = target != ignore_index
    t = torch.where(valid, target, 0)
    nll = -torch.log_softmax(logits, 1).gather(1, t[:, None])[:, 0]
    if weights is not None:
        nll = nll * weights.to(nll.device)[t]
    return torch.where(valid, nll, 0.0)


def _correct_mask(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int) -> torch.Tensor:
    mask = (logits.argmax(1) == target) & (target != ignore_index)
    return mask.detach().to(logits.dtype)


def masked_cross_entropy(logits, target, weights=None, ignore_index=-1):
    """Mask-CE-avg: CE on the pixels currently classified correctly."""
    del weights
    return _correct_mask(logits, target, ignore_index) * \
        cross_entropy_pixelwise(logits, target, None, ignore_index)


def masked_cross_entropy_balanced(logits, target, weights=None,
                                  ignore_index=-1):
    """Mask-CE-bal: class-weighted Mask-CE."""
    return _correct_mask(logits, target, ignore_index) * \
        cross_entropy_pixelwise(logits, target, weights, ignore_index)


def _kl_term(log_m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Pointwise ``p (log p - log m)`` with ``0 log 0 = 0``."""
    pos = p > 0
    xlogx = torch.where(pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0)
    return xlogx - p * log_m


def js_div_pixelwise(logits, target, ignore_index=-1):
    """Per-pixel Jensen-Shannon divergence between softmax(logits) and
    one-hot(target); ignored labels fold to class 0 for the one-hot and
    their loss is zeroed (``semseg/attacker.py:187-234``)."""
    valid = target != ignore_index
    t = torch.where(valid, target, 0)
    p = torch.softmax(logits, 1)
    q = F.one_hot(t, logits.shape[1]).permute(0, 3, 1, 2).to(logits.dtype)
    m = (p + q) / 2.0
    log_m = torch.log(torch.clamp_min(m, _TINY))
    loss = ((_kl_term(log_m, p) + _kl_term(log_m, q)) / 2.0).sum(1)
    return torch.where(valid, loss, 0.0)


def js_loss(logits, target, weights=None, ignore_index=-1):
    """JS-Avg attack criterion; weights are accepted and ignored."""
    del weights
    return js_div_pixelwise(logits, target, ignore_index)


def _gather_class(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``x[:, target]`` per pixel as a one-hot select-and-sum: a label
    outside [0, K) (the ignore label) gives 0, as in the JAX package."""
    iota = torch.arange(x.shape[1], device=x.device).reshape(
        (1, -1) + (1,) * (x.ndim - 2))
    return torch.where(iota == target[:, None], x, 0.0).sum(1)


def margin_loss(logits, target, ignore_index=-1):
    """Per-pixel logit margin ``max_{c != y} z_c - z_y``
    (``semseg/attacker.py:176-184``); an ignored label has an all-zero
    one-hot row."""
    valid = target != ignore_index
    k = logits.shape[1]
    y = F.one_hot(torch.where(valid, target, 0), k).permute(
        0, 3, 1, 2).to(logits.dtype) * valid[:, None].to(logits.dtype)
    logits_target = (y * logits).sum(1)
    logits_other = (logits - 1e10 * y).amax(1)
    return logits_other - logits_target


def dlr_loss(logits, target):
    """DLR loss over the class axis (``semseg/attacker.py:123-131``,
    per pixel)."""
    x_sorted = torch.sort(logits, dim=1).values
    ind = (logits.argmax(1) == target).to(logits.dtype)
    zy = _gather_class(logits, target)
    return -(zy - x_sorted[:, -2] * ind - x_sorted[:, -1] * (1.0 - ind)) / (
        x_sorted[:, -1] - x_sorted[:, -3] + 1e-12)


def dlr_loss_targeted(logits, target, y_target):
    """Targeted DLR over the class axis (``semseg/attacker.py:134-140``)."""
    x_sorted = torch.sort(logits, dim=1).values
    zy = _gather_class(logits, target)
    zt = _gather_class(logits, y_target)
    return -(zy - zt) / (x_sorted[:, -1]
                         - 0.5 * (x_sorted[:, -3] + x_sorted[:, -4]) + 1e-12)


def targeted_cross_entropy(logits, y_target, weights=None, ignore_index=-1):
    """-CE toward the target class: maximising it pushes pixels to the
    target (the working form of the reference's targeted branch,
    ``semseg/attacker.py:600-620``, whose loss names are not in its
    criterion registry)."""
    return -cross_entropy_pixelwise(logits, y_target, weights, ignore_index)


def pixel_to_img_loss(loss: torch.Tensor,
                      mask_background: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(B, H, W) pixel losses -> (B,) image losses, mean over ALL pixels."""
    if mask_background is not None:
        loss = loss * mask_background
    return loss.reshape(loss.shape[0], -1).mean(-1)


def _ce(logits, target, weights=None, ignore_index=-1):
    del weights
    return cross_entropy_pixelwise(logits, target, None, ignore_index)


# (logits, target, weights) -> per-pixel loss (B, H, W)
ATTACK_CRITERIA = {
    "ce": _ce,
    "ce-avg": _ce,
    "mask-ce-avg": masked_cross_entropy,
    "mask-ce-bal": masked_cross_entropy_balanced,
    "js-avg": js_loss,
    "ce-targeted": targeted_cross_entropy,
}


def make_attack_criterion(name: str) -> Callable:
    if name not in ATTACK_CRITERIA:
        raise ValueError(
            f"Unknown attack criterion {name!r}; available: "
            f"{sorted(ATTACK_CRITERIA)}")
    return ATTACK_CRITERIA[name]


# ---------------------------------------------------------------------------
# Training losses (parity: semseg/losses.py)
# ---------------------------------------------------------------------------

def segmentation_cross_entropy(logits, target: torch.Tensor,
                               ignore_index: int = -1,
                               weights: Optional[torch.Tensor] = None,
                               aux_weights=(1.0, 0.4, 0.4)) -> torch.Tensor:
    """Mean CE over the non-ignored pixels (over their class-weight sum
    when ``weights`` is given); a tuple of logits is the weighted sum of
    its terms with ``aux_weights``. An all-ignored batch gives 0."""
    if isinstance(logits, (tuple, list)):
        return sum(w * segmentation_cross_entropy(lg, target, ignore_index,
                                                  weights)
                   for lg, w in zip(logits, aux_weights))
    valid = target != ignore_index
    per_pix = cross_entropy_pixelwise(logits, target, weights, ignore_index)
    if weights is not None:
        t = torch.where(valid, target, 0)
        denom = torch.where(valid, weights.to(per_pix)[t], 0.0).sum()
    else:
        denom = valid.sum().to(per_pix.dtype)
    return per_pix.sum() / denom.clamp_min(1.0)


def ohem_cross_entropy(logits, target: torch.Tensor, ignore_index: int = -1,
                       thresh: float = 0.7,
                       aux_weights=(1.0, 1.0)) -> torch.Tensor:
    """Online hard-example-mining CE in the JAX package's static-shape form:
    sort the per-pixel losses once and keep the top max(#(loss >
    -log(thresh)), #valid // 16)."""
    if isinstance(logits, (tuple, list)):
        return sum(w * ohem_cross_entropy(lg, target, ignore_index, thresh)
                   for lg, w in zip(logits, aux_weights))
    thresh_v = -torch.log(torch.tensor(thresh, dtype=torch.float32))
    valid = target != ignore_index
    n_min = valid.sum() // 16
    loss = cross_entropy_pixelwise(logits, target, None,
                                   ignore_index).reshape(-1)
    loss_sorted = torch.sort(loss, descending=True).values
    n_keep = torch.maximum((loss > thresh_v.to(loss.device)).sum(), n_min)
    keep = torch.arange(loss.numel(), device=loss.device) < n_keep
    return torch.where(keep, loss_sorted, 0.0).sum() / n_keep.clamp_min(1)


def dice_loss(logits, target: torch.Tensor, delta: float = 0.5,
              aux_weights=(1.0, 0.4, 0.4)) -> torch.Tensor:
    """Dice loss on the raw logits (no softmax), as the reference computes
    it; an ignored label has an all-zero one-hot row."""
    if isinstance(logits, (tuple, list)):
        return sum(w * dice_loss(lg, target, delta)
                   for lg, w in zip(logits, aux_weights))
    k = logits.shape[1]
    valid = (target >= 0) & (target < k)
    labels = F.one_hot(torch.where(valid, target, 0), k).to(logits.dtype)
    labels = (labels * valid[..., None]).permute(0, 3, 1, 2)
    axes = tuple(range(2, logits.ndim))
    tp = (labels * logits).sum(axes)
    fn = (labels * (1.0 - logits)).sum(axes)
    fp = ((1.0 - labels) * logits).sum(axes)
    dice = (tp + 1e-6) / (tp + delta * fn + (1 - delta) * fp + 1e-6)
    return ((1.0 - dice).sum(-1) / k).mean()


def get_train_loss(name: str = "CrossEntropy", ignore_label: int = -1,
                   cls_weights: Optional[torch.Tensor] = None) -> Callable:
    """Training-loss factory; parity: ``semseg/losses.py:99-109``."""
    if name == "CrossEntropy":
        return lambda lg, y: segmentation_cross_entropy(
            lg, y, ignore_label, cls_weights)
    if name == "OhemCrossEntropy":
        return lambda lg, y: ohem_cross_entropy(lg, y, ignore_label)
    if name == "Dice":
        return lambda lg, y: dice_loss(lg, y)
    raise ValueError(f"Unavailable loss function name >> {name}")
