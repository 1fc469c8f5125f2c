"""UperNet (PSP + FPN decode head, FCN auxiliary head) over ConvNeXt.

Port of ``robseg_tpu/models/upernet.py``. With labels the model returns
``(loss, logits)``, loss = CE(main) + 0.4 CE(aux) with ignore -1, the aux
head on ``feats[2]`` resized with align_corners=False (JAX ``:145-167``).
The ``fpn_bottleneck`` runs in one of JAX's ``fused_head`` settings
(``upernet.py:73-111``):

  * ``"split"`` (the port's default, the main path): four per-source 3x3
    convs on slices of the bottleneck weight, summed, then the folded
    BatchNorm and ReLU, so the 2048-channel concat is never built;
  * ``True`` or ``"pallas"``: the same function through the FPN
    concat-conv kernel (``kernels/fpn_conv.py``), bf16 operands, output in
    the maps' dtype;
  * ``False``: the concat followed by the ``ConvModule``, the only
    setting that trains: the other two fold the eval BatchNorm, so they
    raise in train mode (``upernet.py:69-74``).

The BatchNorm fold ``s, t`` is computed in float32 whatever the
parameters' dtype (JAX ``upernet.py:95-96``); the split bottleneck casts
it, and its weight slices, to the maps' dtype (JAX ``:100-101``), the
kernel takes it in float32.

Module names follow the reference ``state_dict``
(``semseg/models/uperforseg.py``); every setting has the same parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.kernels.fpn_conv import fpn_concat_conv
from robseg_torch.models.convnext import CONVNEXT_SETTINGS, ConvNeXt
from robseg_torch.models.layers import AdaptiveAvgPool, Conv2d, ConvModule
from robseg_torch.ops import precision
from robseg_torch.ops.losses import segmentation_cross_entropy
from robseg_torch.ops.resize import resize_bilinear

FUSED_HEADS = (False, "split", True, "pallas")


class UperNetHead(nn.Module):
    """PSP on the top feature, lateral 1x1s, top-down FPN, per-level 3x3s,
    the bottleneck in the ``fused_head`` setting, 1x1 classifier."""

    def __init__(self, num_classes: int,
                 in_channels: Sequence[int] = (96, 192, 384, 768),
                 channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 fused_head: object = "split"):
        super().__init__()
        if fused_head not in FUSED_HEADS:
            raise ValueError(f"unknown fused_head {fused_head!r}; one of "
                             f"{FUSED_HEADS}")
        self.fused_head = fused_head
        self.channels = channels
        self.psp_modules = nn.ModuleList([
            nn.Sequential(AdaptiveAvgPool(s),
                          ConvModule(in_channels[-1], channels, 1))
            for s in pool_scales])
        self.bottleneck = ConvModule(
            in_channels[-1] + len(pool_scales) * channels, channels, 3, 1)
        self.lateral_convs = nn.ModuleList([
            ConvModule(c, channels, 1) for c in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([
            ConvModule(channels, channels, 3, 1) for _ in in_channels[:-1]])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3, 1)
        self.classifier = Conv2d(channels, num_classes, 1)

    def _bn_fold(self):
        """The eval BatchNorm of the bottleneck as a float32 scale and
        shift."""
        bn = self.fpn_bottleneck.batch_norm
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        return s, bn.bias.float() - bn.running_mean.float() * s

    def _split_bottleneck(self, fpn_outs) -> torch.Tensor:
        """relu(bn(conv3x3(concat(fpn_outs)))) as a sum of per-source convs
        with the eval BatchNorm folded into a scale and shift."""
        conv = self.fpn_bottleneck.conv
        ch = self.channels
        acc = None
        for i, f in enumerate(fpn_outs):
            o = precision.conv2d(
                f, conv.weight[:, i * ch:(i + 1) * ch].to(f.dtype), padding=1)
            acc = o if acc is None else acc + o
        s, t = (v.to(acc.dtype)[:, None, None] for v in self._bn_fold())
        return F.relu(acc * s + t)

    def _kernel_bottleneck(self, fpn_outs) -> torch.Tensor:
        """The same function through ``fpn_concat_conv``, on channels-last
        copies of the maps and the weight cut into per-source slices."""
        w = self.fpn_bottleneck.conv.weight       # (Co, n*C, 3, 3)
        n, ch = len(fpn_outs), self.channels
        w = w.reshape(w.shape[0], n, ch, 3, 3).permute(1, 3, 4, 2, 0)
        xs = [f.permute(0, 2, 3, 1).contiguous() for f in fpn_outs]
        s, t = self._bn_fold()
        return fpn_concat_conv(xs, w, s, t).permute(0, 3, 1, 2)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        top = feats[-1]
        psp_outs = [top] + [resize_bilinear(m(top), top.shape[-2:])
                            for m in self.psp_modules]
        psp = self.bottleneck(torch.cat(psp_outs, dim=1))

        laterals = [conv(feats[i]) for i, conv in
                    enumerate(self.lateral_convs)] + [psp]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[-2:])
        fpn_outs = [conv(laterals[i]) for i, conv in
                    enumerate(self.fpn_convs)] + [laterals[-1]]
        size = fpn_outs[0].shape[-2:]
        fpn_outs = [fpn_outs[0]] + [resize_bilinear(f, size)
                                    for f in fpn_outs[1:]]
        if self.fused_head and self.training:
            raise RuntimeError(
                f"fused_head={self.fused_head!r} folds the eval BatchNorm "
                "and runs in eval mode only; train with fused_head=False")
        if self.fused_head == "split":
            x = self._split_bottleneck(fpn_outs)
        elif self.fused_head:
            x = self._kernel_bottleneck(fpn_outs)
        else:
            x = self.fpn_bottleneck(torch.cat(fpn_outs, dim=1))
        return self.classifier(x)


class UperNetFCNHead(nn.Module):
    """Auxiliary FCN head on ``feats[in_index]``; it runs only in the loss
    branch (``forward(x, labels)``)."""

    def __init__(self, num_classes: int, in_channels: int = 384,
                 in_index: int = 2, channels: int = 256):
        super().__init__()
        self.in_index = in_index
        self.convs = nn.ModuleList([ConvModule(in_channels, channels, 3, 1)])
        self.classifier = Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.classifier(self.convs[0](feats[self.in_index]))


class UperNetForSemanticSegmentation(nn.Module):
    """Full UperNet-ConvNeXt: ``forward(x)`` on NCHW images in [0, 1]
    returns NCHW logits bilinearly resized to the input size;
    ``forward(x, labels)`` returns ``(loss, logits)``. ``fused_mlp``,
    ``fused_mlp_mode`` and ``fused_head`` are JAX's settings (see
    ``models/convnext.py`` and ``UperNetHead``); the defaults are the main
    path's block kernel and split bottleneck, eval only. Train mode needs
    ``fused_mlp=False, fused_head=False`` (``build_model(...,
    fused=False)``)."""

    def __init__(self, backbone_variant: str = "T_CVST",
                 num_classes: int = 21, fused_mlp: bool = True,
                 fused_mlp_mode: str = "block", fused_head: object = "split"):
        super().__init__()
        dims = CONVNEXT_SETTINGS[backbone_variant][1]
        aux_ch = CONVNEXT_SETTINGS[backbone_variant][2]
        self.backbone = ConvNeXt(backbone_variant, fused_mlp=fused_mlp,
                                 fused_mlp_mode=fused_mlp_mode)
        self.decode_head = UperNetHead(num_classes, in_channels=dims,
                                       fused_head=fused_head)
        self.auxiliary_head = UperNetFCNHead(num_classes, in_channels=aux_ch)

    def forward(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        feats = self.backbone(x)
        logits = resize_bilinear(self.decode_head(feats), x.shape[-2:])
        if labels is None:
            return logits
        aux = resize_bilinear(self.auxiliary_head(feats), x.shape[-2:])
        loss = (segmentation_cross_entropy(logits, labels, -1)
                + 0.4 * segmentation_cross_entropy(aux, labels, -1))
        return loss, logits
