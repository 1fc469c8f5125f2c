"""PSPNet, PSPNet-DDCAT, DeepLabV3 and DeepLabV3-DDCAT over a dilated
ResNet-50.

Port of ``robseg_tpu/models/pspnet.py``, on NCHW tensors:

  * ``PPM``: pyramid pooling at bins (1, 2, 3, 6), each bin a 1x1 conv,
    BatchNorm and ReLU, upsampled back;
  * ``ASPP``: a 1x1 branch, 3x3 branches at atrous rates (6, 12, 18) and
    image-level pooling;
  * the classifier heads: conv (3x3 for PSPNet, 1x1 for DeepLab), BatchNorm,
    ReLU, Dropout2d, then a 1x1 classifier;
  * the output resized to ((H - 1) / 8 * zoom + 1) along each axis, which is
    the input size at zoom 8; the input must satisfy (H - 1) % 8 == 0.

Every resize here is bilinear with align_corners=True. ``PSPNet(x,
labels)`` and ``DeepLabV3(x, labels)`` return ``(main_loss, aux_loss,
logits)`` with the aux head on ``layer3``'s output (JAX ``:127-153``); in
train mode (or with ``indicate=1``) a DDCAT model returns ``(final, aux,
mask, normal)``, ``final`` taking the adversarial branch where the
2-channel mask head's argmax is 1 (``:175-210``); in eval it returns its
normal branch. Train mode runs the BatchNorms on batch statistics and
the heads' ``Dropout2d`` (``models/layers.py``).

Module names: ``PSPNet`` has the reference's layout (``layer0`` to
``layer4``, ``ppm.features.{i}``, ``cls``, ``aux``), the keys
``robseg_tpu/convert/torch2jax.py::convert_pspnet`` reads. The other three
have no converter in the JAX package; their names follow the JAX parameter
tree (``backbone``, ``ppm``, ``aspp``, ``cls``, ``cls1``, ``cls2``,
``mask1``, ``aux``, ``aux_cls1``), with the reference ResNet's names inside
``backbone`` and the reference PPM inside ``ppm``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.models.layers import AdaptiveAvgPool, Conv2d, Dropout2d
from robseg_torch.models.resnet import ResNetStages, bn
from robseg_torch.ops.losses import segmentation_cross_entropy
from robseg_torch.ops.resize import adaptive_avg_pool, resize_bilinear


class ConvBnRelu(nn.Module):
    """Conv (no bias, 'same' padding at its dilation), BatchNorm, ReLU; the
    JAX ``_ConvBnRelu`` (``conv``, ``bn``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel,
                           padding=(kernel // 2) * dilation,
                           dilation=dilation, bias=False)
        self.bn = bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class PPM(nn.Module):
    """Pyramid pooling: ``features.{i}`` = (pool, conv, bn, ReLU)."""

    def __init__(self, in_dim: int, reduction_dim: int,
                 bins: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.features = nn.ModuleList([
            nn.Sequential(AdaptiveAvgPool(b),
                          Conv2d(in_dim, reduction_dim, 1, bias=False),
                          bn(reduction_dim), nn.ReLU())
            for b in bins])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[-2:]
        return torch.cat([x] + [resize_bilinear(f(x), hw, align_corners=True)
                                for f in self.features], dim=1)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling."""

    def __init__(self, in_dim: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.conv0 = ConvBnRelu(in_dim, out_channels, 1)
        for i, rate in enumerate(atrous_rates):
            setattr(self, f"atrous{i}",
                    ConvBnRelu(in_dim, out_channels, 3, dilation=rate))
        self.n_rates = len(atrous_rates)
        self.image_pool = ConvBnRelu(in_dim, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = [self.conv0(x)] + [getattr(self, f"atrous{i}")(x)
                                 for i in range(self.n_rates)]
        pooled = self.image_pool(adaptive_avg_pool(x, (1, 1)))
        res.append(resize_bilinear(pooled, x.shape[-2:], align_corners=True))
        return torch.cat(res, dim=1)


def cls_head(in_ch: int, mid: int, classes: int, kernel: int = 3,
             dropout: float = 0.1) -> nn.Sequential:
    """conv(kernel) + BatchNorm + ReLU + Dropout2d + 1x1 classifier, the
    reference's Sequential (keys ``.0``, ``.1``, ``.4``)."""
    return nn.Sequential(
        Conv2d(in_ch, mid, kernel, padding=kernel // 2, bias=False), bn(mid),
        nn.ReLU(), Dropout2d(dropout), Conv2d(mid, classes, 1))


def zoom_hw(x: torch.Tensor, zoom_factor: int) -> Tuple[int, int]:
    h, w = x.shape[-2:]
    assert (h - 1) % 8 == 0 and (w - 1) % 8 == 0, (h, w)
    return (h - 1) // 8 * zoom_factor + 1, (w - 1) // 8 * zoom_factor + 1


def _zoom(logits: torch.Tensor, out_hw, zoom_factor: int) -> torch.Tensor:
    if zoom_factor == 1:
        return logits
    return resize_bilinear(logits, out_hw, align_corners=True)


def _losses(logits, aux, labels):
    """(main_loss, aux_loss, logits) of the loss branch."""
    return (segmentation_cross_entropy(logits, labels, -1),
            segmentation_cross_entropy(aux, labels, -1), logits)


def _ddcat_out(self, feat, x3, out_hw, indicate: int):
    """The DDCAT heads: ``normal`` in eval, else ``(final, aux, mask,
    normal)``."""
    normal = _zoom(self.cls1(feat), out_hw, self.zoom_factor)
    if not (self.training or indicate == 1):
        return normal
    adver = _zoom(self.cls2(feat), out_hw, self.zoom_factor)
    mask = _zoom(self.mask1(feat), out_hw, self.zoom_factor)
    sel = mask.argmax(1, keepdim=True).to(normal.dtype)
    final = sel * adver + (1.0 - sel) * normal
    aux = _zoom(self.aux_cls1(x3), out_hw, self.zoom_factor)
    return final, aux, mask, normal


class PSPNet(nn.Module):
    """PSPNet-ResNet50: ``forward(x)`` returns the logits,
    ``forward(x, labels)`` ``(main_loss, aux_loss, logits)``."""

    def __init__(self, classes: int = 21, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, zoom_factor: int = 8,
                 use_ppm: bool = True, deep_base: bool = True):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.use_ppm = use_ppm
        stages = ResNetStages(deep_base=deep_base)
        self.layer0 = stages.stem()
        for s in range(1, 5):
            setattr(self, f"layer{s}", getattr(stages, f"layer{s}"))
        fea_dim = 2048
        if use_ppm:
            self.ppm = PPM(fea_dim, fea_dim // len(bins), bins)
            fea_dim *= 2
        self.cls = cls_head(fea_dim, 512, classes, 3, dropout)
        self.aux = cls_head(1024, 256, classes, 3, dropout)

    def forward(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        out_hw = zoom_hw(x, self.zoom_factor)
        x3 = self.layer3(self.layer2(self.layer1(self.layer0(x))))
        x = self.layer4(x3)
        if self.use_ppm:
            x = self.ppm(x)
        logits = _zoom(self.cls(x), out_hw, self.zoom_factor)
        if labels is None:
            return logits
        return _losses(logits, _zoom(self.aux(x3), out_hw, self.zoom_factor),
                       labels)


class PSPNetDDCAT(nn.Module):
    """Dual-branch DDCAT PSPNet (7x7 stem); eval returns the normal branch,
    train mode or ``indicate=1`` the ``(final, aux, mask, normal)`` tuple.
    ``backbone_layers``, ``backbone_planes``, ``head_width`` and
    ``aux_width`` are the JAX module's geometry fields."""

    def __init__(self, classes: int = 21, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, zoom_factor: int = 8,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 backbone_planes: Sequence[int] = (64, 128, 256, 512),
                 head_width: int = 512, aux_width: int = 256):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.backbone = ResNetStages(layers=backbone_layers,
                                     planes=backbone_planes, deep_base=False)
        c4, c3 = backbone_planes[3] * 4, backbone_planes[2] * 4
        self.ppm = PPM(c4, c4 // len(bins), bins)
        fea = c4 + len(bins) * (c4 // len(bins))
        self.cls1 = cls_head(fea, head_width, classes, 3, dropout)
        self.cls2 = cls_head(fea, head_width, classes, 3, dropout)
        self.mask1 = cls_head(fea, head_width, 2, 3, dropout)
        self.aux_cls1 = cls_head(c3, aux_width, classes, 3, dropout)

    def forward(self, x: torch.Tensor, indicate: int = 0):
        out_hw = zoom_hw(x, self.zoom_factor)
        x3, x4 = self.backbone(x)
        return _ddcat_out(self, self.ppm(x4), x3, out_hw, indicate)


class DeepLabV3(nn.Module):
    """DeepLabV3-ResNet50 with ASPP: ``forward(x)`` returns the logits,
    ``forward(x, labels)`` ``(main_loss, aux_loss, logits)``."""

    def __init__(self, classes: int = 21,
                 atrous_rates: Sequence[int] = (6, 12, 18),
                 dropout: float = 0.1, zoom_factor: int = 8,
                 deep_base: bool = True):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.backbone = ResNetStages(deep_base=deep_base)
        self.aspp = ASPP(2048, 256, atrous_rates)
        fea = 256 * (len(atrous_rates) + 2)
        self.cls = cls_head(fea, 256, classes, 1, dropout)
        self.aux = cls_head(1024, 256, classes, 1, dropout)

    def forward(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        out_hw = zoom_hw(x, self.zoom_factor)
        x3, x4 = self.backbone(x)
        logits = _zoom(self.cls(self.aspp(x4)), out_hw, self.zoom_factor)
        if labels is None:
            return logits
        return _losses(logits, _zoom(self.aux(x3), out_hw, self.zoom_factor),
                       labels)


class DeepLabV3DDCAT(nn.Module):
    """Dual-branch DDCAT DeepLabV3 (7x7 stem, 1x1 heads); eval returns the
    normal branch, train mode or ``indicate=1`` the ``(final, aux, mask,
    normal)`` tuple."""

    def __init__(self, classes: int = 21,
                 atrous_rates: Sequence[int] = (6, 12, 18),
                 dropout: float = 0.1, zoom_factor: int = 8):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.backbone = ResNetStages(deep_base=False)
        self.aspp = ASPP(2048, 256, atrous_rates)
        fea = 256 * (len(atrous_rates) + 2)
        self.cls1 = cls_head(fea, 256, classes, 1, dropout)
        self.cls2 = cls_head(fea, 256, classes, 1, dropout)
        self.mask1 = cls_head(fea, 256, 2, 1, dropout)
        self.aux_cls1 = cls_head(1024, 256, classes, 1, dropout)

    def forward(self, x: torch.Tensor, indicate: int = 0):
        out_hw = zoom_hw(x, self.zoom_factor)
        x3, x4 = self.backbone(x)
        return _ddcat_out(self, self.aspp(x4), x3, out_hw, indicate)
