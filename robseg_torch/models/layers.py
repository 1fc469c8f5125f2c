"""Shared building blocks.

Port of ``robseg_tpu/models/layers.py``: ``ConvModule`` (conv without
bias, BatchNorm with eps 1e-5, ReLU) and the ConvNeXt LayerNorm with eps
1e-6. Module names follow the reference ``state_dict`` (``conv``,
``batch_norm``). DropPath is the identity in eval mode, and the port runs
eval mode only, so it has no module here.

The layers with parameters (``Conv2d``, ``Linear``, ``LayerNorm``,
``BatchNorm2d``) compute in JAX's dtype: flax modules with ``dtype=None``
promote the input and the parameters to their common dtype, where torch's
``conv2d``, ``linear`` and ``layer_norm`` raise on mixed dtypes. Under
``--precision bf16`` that happens after the first float32 output of an
MLP-tail kernel (``models/convnext.py``). The norms then run torch's own
kernels, which take a bf16 input's statistics in float32 and round the
output once, as flax's norms do. For float32 inputs and parameters every
layer is the plain torch one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.ops.resize import adaptive_avg_pool

LN_EPS = 1e-6


def promote(x: torch.Tensor, *params):
    """``x`` and the parameters (``None`` kept) in their promoted dtype."""
    dt = functools.reduce(torch.promote_types,
                          [p.dtype for p in params if p is not None], x.dtype)
    return [t if t is None or t.dtype == dt else t.to(dt)
            for t in (x, *params)]


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*promote(x, self.weight, self.bias))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        return F.batch_norm(*promote(x, self.running_mean, self.running_var,
                                     self.weight, self.bias),
                            False, 0.0, self.eps)


class ConvModule(nn.Module):
    """Conv2d (no bias) + BatchNorm2d + ReLU on NCHW tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 0):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, padding=padding,
                           bias=False)
        self.batch_norm = BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.batch_norm(self.conv(x)))


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channel axis of an NCHW tensor (eps 1e-6), the
    reference's ``data_format="channels_first"`` LayerNorm."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class AdaptiveAvgPool(nn.Module):
    """``ops.resize.adaptive_avg_pool`` as a module (the PSP pool slot)."""

    def __init__(self, out_size: int):
        super().__init__()
        self.out_size = out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, (self.out_size, self.out_size))
