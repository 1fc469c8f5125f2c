"""The plain reference of the scoring: per-image confusion counts and the
summary the SEA attack loop prints (mAcc, aAcc, mIoU), from integer counts.
"""

from __future__ import annotations

import torch


def per_image_counts(pred, y, k: int):
    """(intersection, union) per image and class, int64 ``(B, K)``, over
    the pixels whose label is not -1."""
    b = pred.shape[0]
    valid = (y != -1).reshape(b, -1)
    t = y.reshape(b, -1).clamp_min(0)
    p = pred.reshape(b, -1).clamp(0, k - 1)
    img = torch.arange(b, device=pred.device)[:, None].expand_as(t)
    idx = ((img * k + t) * k + p)[valid]
    hist = torch.bincount(idx, minlength=b * k * k).reshape(b, k, k)
    inter = torch.diagonal(hist, dim1=1, dim2=2)
    return inter, hist.sum(1) + hist.sum(2) - inter, hist.sum(0)


def summary(hist: torch.Tensor):
    """(mAcc, aAcc, mIoU) in float64 of a K x K count matrix; a class
    without pixels (accuracy) or without union (IoU) is left out."""
    h = hist.double()
    inter = torch.diagonal(h)
    gt, pr = h.sum(1), h.sum(0)
    union = gt + pr - inter
    macc = (inter[gt > 0] / gt[gt > 0]).mean()
    aacc = inter.sum() / h.sum().clamp_min(1)
    miou = (inter[union > 0] / union[union > 0]).mean()
    return float(macc), float(aacc), float(miou)
