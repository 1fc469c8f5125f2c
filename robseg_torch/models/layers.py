"""Shared building blocks.

Port of ``robseg_tpu/models/layers.py``: ``ConvModule`` (conv without
bias, BatchNorm with eps 1e-5, ReLU) and the ConvNeXt LayerNorm with eps
1e-6. Module names follow the reference ``state_dict`` (``conv``,
``batch_norm``). ``trunc_normal_`` is the timm-style init of the ViT
layers.

Training semantics are flax's, since the port is held against the JAX
package: ``BatchNorm2d`` in train mode normalises with the batch
statistics and moves its running statistics by an EMA of decay 0.9
(torch's momentum 0.1) towards the batch mean and the *biased* batch
variance (torch's own BatchNorm stores the unbiased one). ``DropPath``
(stochastic depth per sample), ``Dropout2d`` (per channel) and
``Dropout`` (per element) draw their masks from the ``torch.Generator``
that ``set_generator`` hands them (the default generator when none);
each is the identity in eval mode or at rate 0.

The layers with parameters (``Conv2d``, ``Linear``, ``LayerNorm``,
``BatchNorm2d``) compute in JAX's dtype: flax modules with ``dtype=None``
promote the input and the parameters to their common dtype, where torch's
``conv2d``, ``linear`` and ``layer_norm`` raise on mixed dtypes. Under
``--precision bf16`` that happens after the first float32 output of an
MLP-tail kernel (``models/convnext.py``). The norms then run torch's own
kernels, which take a bf16 input's statistics in float32 and round the
output once, as flax's norms do. For float32 inputs and parameters every
layer is the plain torch one.

``Conv2d`` and ``Linear`` compute their products through
``ops.precision``: the plain torch call, or bf16-rounded operands under
the train CLI's bf16 products (``jax_default_matmul_precision=bfloat16``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.ops import precision
from robseg_torch.ops.resize import adaptive_avg_pool

LN_EPS = 1e-6


def promote(x: torch.Tensor, *params):
    """``x`` and the parameters (``None`` kept) in their promoted dtype."""
    dt = functools.reduce(torch.promote_types,
                          [p.dtype for p in params if p is not None], x.dtype)
    return [t if t is None or t.dtype == dt else t.to(dt)
            for t in (x, *params)]


class Conv2d(nn.Conv2d):
    """Zero padding only; its product through ``ops.precision``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.conv2d(*promote(x, self.weight, self.bias),
                                self.stride, self.padding, self.dilation,
                                self.groups)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        return F.batch_norm(*promote(x, self.running_mean, self.running_var,
                                     self.weight, self.bias),
                            False, 0.0, self.eps)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics; the running variance takes the biased batch
        variance. ``F.batch_norm`` moves it towards the unbiased one, so
        the step is rescaled by (n - 1) / n afterwards."""
        n = x.numel() // x.shape[1]
        m = self.momentum
        if n < 2:  # torch refuses a single value per channel; flax does not
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            shape = (1, -1, 1, 1)
            y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(
                shape)
            y = y * self.weight.view(shape) + self.bias.view(shape)
        else:
            # autograd keeps the variance buffer it was given: a copy
            var = self.running_var.clone()
            y = F.batch_norm(x, self.running_mean, var, self.weight,
                             self.bias, True, m, self.eps)
            with torch.no_grad():
                old = (1 - m) * self.running_var
                self.running_var.copy_(old + (var - old) * ((n - 1) / n))
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        return y


def trunc_normal_(t: torch.Tensor, std: float = 0.02) -> torch.Tensor:
    """timm-style truncated normal (+-2 std) init, in place."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class _Drop(nn.Module):
    """A mask of keep probability 1 - rate over ``_mask_shape(x)``, the
    kept values scaled by 1 / keep, drawn from ``self.generator``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator = None

    def _mask_shape(self, x: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(self._mask_shape(x), generator=self.generator,
                       device=x.device)
        return x * (u < keep).to(x.dtype) / keep


class DropPath(_Drop):
    """Stochastic depth per sample (timm semantics)."""

    def _mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.ndim - 1)


class Dropout2d(_Drop):
    """Channel dropout (torch's ``nn.Dropout2d``) of an NCHW tensor."""

    def _mask_shape(self, x):
        return x.shape[:2] + (1, 1)


class Dropout(_Drop):
    """Element dropout (torch's ``nn.Dropout``)."""

    def _mask_shape(self, x):
        return x.shape


def set_generator(module: nn.Module, generator) -> None:
    """Hand ``generator`` to every dropout layer of ``module``."""
    for m in module.modules():
        if isinstance(m, _Drop):
            m.generator = generator


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
