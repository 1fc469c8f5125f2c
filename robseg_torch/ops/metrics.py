"""Segmentation metrics from confusion matrices.

Port of ``robseg_tpu/ops/metrics.py``. ``confusion_matrix`` and the
per-image histograms of ``per_image_intersect_union`` go through the
confusion kernel (``kernels/confusion.py``). ``pred``/``target`` are integer
tensors of one shape; pixels whose target is ``ignore_label`` count nowhere.
"""

from __future__ import annotations

import torch

from robseg_torch.kernels.confusion import confusion_hist


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, *,
                     num_classes: int, ignore_label: int = -1
                     ) -> torch.Tensor:
    """K x K confusion matrix ``hist[true, pred]`` (float32 counts)."""
    return confusion_hist(pred, target, num_classes=num_classes,
                          ignore_label=ignore_label)


def _nan_where_absent(num, den):
    present = den > 0
    vals = torch.where(present, num / torch.where(present, den, 1.0),
                       torch.nan)
    mean = torch.where(present, vals, 0.0).sum() / present.sum().clamp_min(1)
    return vals, mean


def iou_from_hist(hist: torch.Tensor):
    """(per-class IoU, mIoU) over classes with a non-empty union."""
    inter = torch.diagonal(hist)
    return _nan_where_absent(inter, hist.sum(0) + hist.sum(1) - inter)


def f1_from_hist(hist: torch.Tensor):
    """(per-class F1, mean F1)."""
    inter = torch.diagonal(hist)
    return _nan_where_absent(2.0 * inter, hist.sum(0) + hist.sum(1))


def pixel_acc_from_hist(hist: torch.Tensor):
    """(per-class acc, mAcc, aAcc)."""
    inter = torch.diagonal(hist)
    acc, macc = _nan_where_absent(inter, hist.sum(1))
    aacc = inter.sum() / hist.sum().clamp_min(1.0)
    return acc, macc, aacc


def iou_acc_summary(pred: torch.Tensor, target: torch.Tensor, *,
                    num_classes: int, ignore_label: int = -1):
    """``(mAcc, aAcc, mIoU)``, the triple the reference's attack loop
    prints (``semseg/attacker.py:9-52``), from one confusion matrix."""
    hist = confusion_matrix(pred, target, num_classes=num_classes,
                            ignore_label=ignore_label)
    _, macc, aacc = pixel_acc_from_hist(hist)
    _, miou = iou_from_hist(hist)
    return macc, aacc, miou


def per_image_intersect_union(pred: torch.Tensor, target: torch.Tensor, *,
                              num_classes: int, ignore_label: int = -1):
    """Per-image ``(intersection[K], union[K])``, each ``(B, K)`` float32;
    ignored pixels count in neither."""
    hists = confusion_hist(pred, target, num_classes=num_classes,
                           ignore_label=ignore_label, per_image=True)
    inter = torch.diagonal(hists, dim1=1, dim2=2)
    return inter, hists.sum(1) + hists.sum(2) - inter


def per_image_pixel_acc(pred: torch.Tensor, target: torch.Tensor, *,
                        ignore_label: int = -1) -> torch.Tensor:
    """Per-image aAcc over non-ignored pixels, float32 ``(B,)``."""
    valid = target != ignore_label
    correct = (pred == target) & valid
    b = pred.shape[0]
    num = correct.reshape(b, -1).sum(-1).to(torch.float32)
    den = valid.reshape(b, -1).sum(-1).to(torch.float32)
    return num / den.clamp_min(1.0)
