"""Dilated ResNet (the DDCAT flavour) for PSPNet and DeepLabV3.

Port of ``robseg_tpu/models/resnet.py``, on NCHW tensors (train mode:
the BatchNorms of ``models/layers.py`` on batch statistics):
bottleneck blocks with the stride on conv2, the deep-base 3-conv stem
(3x3 convs of 64, 64 and 128 channels) or the 7x7 stem, a 3x3 max pool,
and the segmentation nets' dilation on layers 3 and 4 (dilation 2 and 4 at
stride 1, output stride 8), as constructor arguments.

Module names are the reference ResNet's (``resnet_ddcat.py``): ``conv1``,
``bn1`` (``conv2``, ``bn2``, ``conv3``, ``bn3`` of the deep base),
``layer{1..4}.{b}.{conv,bn}{1,2,3}`` and ``.downsample.{0,1}``, the layout
``robseg_tpu/convert/torch2jax.py::convert_resnet_backbone`` reads.
``PSPNet`` regroups the stem as the reference's ``layer0`` Sequential.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.models.layers import BatchNorm2d, Conv2d

BN_EPS = 1e-5


def bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4), with an identity or a
    projection shortcut."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn2 = bn(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = bn(out)
        self.downsample: Optional[nn.Sequential] = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride=stride, bias=False), bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetStages(nn.Module):
    """Stem + 4 stages; ``forward`` returns (layer3 out, layer4 out). A
    stage with dilation > 1 runs at stride 1 with a dilated conv2.
    ``layers`` and ``planes`` are the JAX module's geometry fields."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 deep_base: bool = True,
                 strides: Sequence[int] = (1, 2, 1, 1),
                 dilations: Sequence[int] = (1, 1, 2, 4),
                 planes: Sequence[int] = (64, 128, 256, 512),
                 stem_channels: Sequence[int] = (64, 64, 128)):
        super().__init__()
        self.layers = tuple(layers)
        self.planes = tuple(planes)
        self.deep_base = deep_base
        if deep_base:
            s1, s2, s3 = stem_channels
            self.conv1 = Conv2d(3, s1, 3, stride=2, padding=1, bias=False)
            self.bn1 = bn(s1)
            self.conv2 = Conv2d(s1, s2, 3, padding=1, bias=False)
            self.bn2 = bn(s2)
            self.conv3 = Conv2d(s2, s3, 3, padding=1, bias=False)
            self.bn3 = bn(s3)
            inplanes = s3
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = bn(64)
            inplanes = 64
        for s in range(4):
            blocks = []
            for b in range(layers[s]):
                stride = strides[s] if b == 0 else 1
                need_ds = b == 0 and (strides[s] != 1
                                      or inplanes != planes[s] * 4)
                blocks.append(Bottleneck(inplanes, planes[s], stride,
                                         dilations[s], need_ds))
                inplanes = planes[s] * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def stem(self) -> nn.Sequential:
        """The stem as the reference's ``layer0``: conv, bn, ReLU per stem
        conv, then the 3x3 max pool."""
        mods = []
        for i in range(1, 4 if self.deep_base else 2):
            mods += [getattr(self, f"conv{i}"), getattr(self, f"bn{i}"),
                     nn.ReLU()]
        return nn.Sequential(*mods, nn.MaxPool2d(3, 2, 1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.deep_base:
            x = F.relu(self.bn2(self.conv2(x)))
            x = F.relu(self.bn3(self.conv3(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x3 = self.layer3(self.layer2(self.layer1(x)))
        return x3, self.layer4(x3)
