"""ConvNeXt backbone with the CvSt convolutional stem.

Port of ``robseg_tpu/models/convnext.py``. Module and parameter names are
the reference's plain ``state_dict`` layout (``convnext_orig.py``, read by
``robseg_tpu/convert/torch2jax.py::convert_convnext_backbone`` with
``cvst_ckpt_layout=False``):

  * ``downsample_layers.0.stem.{0,1,3,4}`` (CvSt stem) or
    ``downsample_layers.0.{0,1}`` (patchify stem);
  * ``downsample_layers.{1,2,3}.{0,1}`` (LayerNorm, 2x2 stride-2 conv);
  * ``stages.{j}.{k}.{dwconv,norm,pwconv1,pwconv2,gamma}``;
  * ``norm{i}``, the per-stage output norms.

Inside each stage the activations stay channels-last ``(B, H, W, C)``, the
layout the block kernel takes; the returned features are NCHW views.

The blocks take JAX's fused settings under JAX's names (``fused_mlp``,
``fused_mlp_mode``; ``robseg_tpu/models/convnext.py:40-160``), with the
routing JAX gives them:

  * ``fused_mlp=True, fused_mlp_mode="block"`` (the port's default, the
    main path): every block through the whole-block kernel
    (``kernels/convnext_block.py``);
  * the MLP-tail modes ``residual``, ``recompute``, ``residual_bf16``,
    ``recompute_bf16``: the depthwise conv as a plain convolution, then,
    for blocks with dim <= 384, the MLP-tail kernel in that mode
    (``kernels/convnext_mlp.py``); wider blocks run the tail in plain ops,
    as JAX does (its kernel's weights outgrow the TPU's VMEM there);
  * ``fused_mlp=False``: the unfused block in plain ops.

The parameters are the same in every setting.

Under ``--precision bf16`` (parameters and input bf16) the dtype trail is
JAX's: the block kernel and the plain block keep bf16, while an MLP-tail
kernel writes float32 (as JAX's does), so ``x + y`` promotes and every
later layer computes in float32 on upcast bf16 parameters
(``models/layers.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.kernels.convnext_block import convnext_block
from robseg_torch.kernels.convnext_mlp import MODES as MLP_MODES
from robseg_torch.kernels.convnext_mlp import convnext_mlp
from robseg_torch.models.layers import (LN_EPS, Conv2d, LayerNorm,
                                        LayerNorm2d, Linear)

# [depths, dims, aux_head_channels, drop_path_rate]
# (copy of robseg_tpu/models/convnext.py:30; tests/test_torch_import.py
# checks that the two agree)
CONVNEXT_SETTINGS = {
    "T": [[3, 3, 9, 3], [96, 192, 384, 768], 384, 0.4],
    "T_CVST": [[3, 3, 9, 3], [96, 192, 384, 768], 384, 0.4],
    "T_CVST_ROB": [[3, 3, 9, 3], [96, 192, 384, 768], 384, 0.4],
    "S_CVST_ROB": [[3, 3, 27, 3], [96, 192, 384, 768], 384, 0.3],
    "S_CVST": [[3, 3, 27, 3], [96, 192, 384, 768], 384, 0.3],
    "B": [[3, 3, 27, 3], [128, 256, 512, 1024], 512, 0.4],
}
FUSED_MLP_MODES = ("block",) + tuple(MLP_MODES)
MLP_KERNEL_MAX_DIM = 384  # robseg_tpu/models/convnext.py:131


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> Linear 4x -> GELU -> Linear -> gamma, residual.

    Eval only, in every setting: the kernels give input gradients and no
    weight gradients, and the port has no DropPath. Train mode raises.
    """

    def __init__(self, dim: int, layer_scale_init_value: float = 1.0,
                 fused_mlp: bool = True, fused_mlp_mode: str = "block"):
        super().__init__()
        if fused_mlp_mode not in FUSED_MLP_MODES:
            raise ValueError(f"unknown fused_mlp_mode {fused_mlp_mode!r}; "
                             f"one of {FUSED_MLP_MODES}")
        self.fused_mlp = fused_mlp
        self.fused_mlp_mode = fused_mlp_mode
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: channels-last (B, H, W, C)."""
        if self.training:
            raise RuntimeError(
                "ConvNeXtBlock runs in eval mode only: its kernel gives no "
                "weight gradients. Training (PIR-AT) is a later port slice "
                "(ROADMAP.md).")
        if self.fused_mlp and self.fused_mlp_mode == "block":
            return convnext_block(
                x, self.dwconv.weight, self.dwconv.bias, self.norm.weight,
                self.norm.bias, self.pwconv1.weight, self.pwconv1.bias,
                self.pwconv2.weight, self.pwconv2.bias, self.gamma)
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.fused_mlp and x.shape[-1] <= MLP_KERNEL_MAX_DIM:
            y = convnext_mlp(
                y.contiguous(), self.norm.weight, self.norm.bias,
                self.pwconv1.weight, self.pwconv1.bias, self.pwconv2.weight,
                self.pwconv2.bias, self.gamma, self.fused_mlp_mode)
        else:
            y = self.gamma * self.pwconv2(F.gelu(self.pwconv1(self.norm(y)),
                                                 approximate="none"))
        return x + y


class CvStStem(nn.Module):
    """Two 3x3 stride-2 convs (3 -> 48 -> 96), LayerNorm + GELU after each."""

    def __init__(self, planes: int = 48):
        super().__init__()
        self.stem = nn.Sequential(
            Conv2d(3, planes, 3, stride=2, padding=1), LayerNorm2d(planes),
            nn.GELU(), Conv2d(planes, 2 * planes, 3, stride=2, padding=1),
            LayerNorm2d(2 * planes), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)


class ConvNeXt(nn.Module):
    """Four-stage feature extractor: NCHW image -> 4 normed NCHW features
    at strides 4, 8, 16, 32."""

    def __init__(self, variant: str = "T_CVST",
                 layer_scale_init_value: float = 1.0, fused_mlp: bool = True,
                 fused_mlp_mode: str = "block"):
        super().__init__()
        if variant not in CONVNEXT_SETTINGS:
            raise ValueError(f"unknown ConvNeXt variant {variant!r}")
        depths, dims, _, _ = CONVNEXT_SETTINGS[variant]
        if "CVST" in variant:
            stem = CvStStem(dims[0] // 2)
        else:
            stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4),
                                 LayerNorm2d(dims[0]))
        self.downsample_layers = nn.ModuleList([stem] + [
            nn.Sequential(LayerNorm(dims[i - 1], eps=LN_EPS),
                          Conv2d(dims[i - 1], dims[i], 2, stride=2))
            for i in range(1, 4)])
        self.stages = nn.ModuleList([
            nn.Sequential(*[ConvNeXtBlock(dims[i], layer_scale_init_value,
                                          fused_mlp, fused_mlp_mode)
                            for _ in range(depths[i])])
            for i in range(4)])
        for i in range(4):
            self.add_module(f"norm{i}", LayerNorm(dims[i], eps=LN_EPS))
        self.apply(self._init_weights)

    @staticmethod
    def _init_weights(m: nn.Module) -> None:
        # reference init: trunc_normal(std=.02) weights, zero biases
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04)
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(4):
            if i == 0:
                x = self.downsample_layers[0](x)
            else:
                ln, conv = self.downsample_layers[i]
                x = conv(ln(x).permute(0, 3, 1, 2))
            x = x.permute(0, 2, 3, 1).contiguous()  # channels-last stage
            x = self.stages[i](x)
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
        return outs
