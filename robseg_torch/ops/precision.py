"""bf16 products inside float32 training: the port's form of
``jax_default_matmul_precision=bfloat16``.

The JAX trainer sets that global config under ``--precision bf16``, and
under ``default`` when ``TRAIN.AMP`` is on (``tools/train.py:98-111``;
the reference's AMP flag, ``train_rob_seg.py:224``). XLA then computes
every dot and convolution as ``DotAlgorithm`` BF16_BF16_F32: each operand
rounded to bf16 (round to nearest even), the products accumulated in
float32, a float32 result. A gradient's products follow the same rule,
the incoming gradient rounded too. Parameters, optimizer state, norms,
losses, biases and the attack's arithmetic stay float32.

``bf16_products()`` turns the mode on for the code it wraps (the train
CLI wraps its whole run: attack, update and evaluations, as JAX's global
config covers all of them). ``conv2d``, ``linear`` and ``matmul`` are the
models' product call sites: the plain torch call with the mode off, a
``torch.autograd.Function`` with it on. Its forward rounds both operands,
its backward rounds the incoming gradient and uses the rounded operands,
saved as bf16 (half the bytes of float32 copies), and only those that a
requested gradient needs. A bias is added after the product, unrounded.
The kernels' plain versions (``robseg_torch/kernels/``) call torch
directly and never see the mode: the kernels round their own operands.

On the card, matmuls run as bf16 cuBLAS products with a float32 output
(``aten.mm.dtype``, ``aten.bmm.dtype``). Convolutions have no float32
output for bf16 operands, and a bf16 output would round once more (a
relative error up to 2^-8 that JAX does not have), so they take the
rounded operands in float32 under TF32, which holds a bf16 value exactly:
the mode turns TF32 on in cuDNN while it is on. On the CPU both take the
rounded operands in float32, whose products are exact.

This is not the SEA CLI's ``--precision bf16``, which casts parameters
and activations to bf16 (``ModelBundle(module, "bf16")``); the two JAX
CLIs mean different things by the flag, and the port keeps both.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

_BF16 = contextvars.ContextVar("bf16_products", default=False)


@contextlib.contextmanager
def bf16_products(on: bool = True):
    """Every product of ``conv2d``, ``linear`` and ``matmul`` inside takes
    bf16-rounded operands (no-op when ``on`` is false). TF32 is on in
    cuDNN meanwhile, and restored after."""
    if not on:
        yield
        return
    token = _BF16.set(True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        _BF16.reset(token)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``torch.matmul`` semantics (both at least 2-D, batch dimensions
    broadcast) of two bf16 tensors, the products accumulated in float32,
    the result in ``dtype``."""
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(f"matmul of {a.dim()}-D and {b.dim()}-D operands: "
                         "the bf16 products take 2-D or more")
    if a.device.type != "cuda" or dtype != torch.float32:
        return torch.matmul(a.to(dtype), b.to(dtype))
    f32 = torch.float32
    if b.dim() == 2:  # (..., m, k) @ (k, n): one product over all rows
        return torch.ops.aten.mm.dtype(a.reshape(-1, a.shape[-1]), b,
                                       f32).view(*a.shape[:-1], b.shape[-1])
    if a.dim() == 2:  # (m, k) @ (..., k, n) = ((..., n, k) @ (k, m))^T
        return _mm(b.transpose(-1, -2), a.t(), dtype).transpose(-1, -2)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.ops.aten.bmm.dtype(a3, b3, f32).view(
        *batch, a.shape[-2], b.shape[-1])


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        need_a, need_b = ctx.needs_input_grad
        ctx.save_for_backward(a16 if need_b else None,
                              b16 if need_a else None)
        ctx.shapes = a.shape, b.shape
        return _mm(a16, b16, a.dtype)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        a_shape, b_shape = ctx.shapes
        g16 = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm(g16, b16.transpose(-1, -2), g.dtype).sum_to_size(
                a_shape)
        if ctx.needs_input_grad[1] and len(b_shape) == 2:
            # one matrix for every row of a (a linear layer's weight): one
            # product over all rows, not one a batch entry summed after
            db = _mm(a16.reshape(-1, a_shape[-1]).t(),
                     g16.reshape(-1, g16.shape[-1]), g.dtype)
        elif ctx.needs_input_grad[1]:
            db = _mm(a16.transpose(-1, -2), g16, g.dtype).sum_to_size(
                b_shape)
        return da, db


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        need_x, need_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(x16 if need_w else None,
                              w16 if need_x else None)
        ctx.conf = stride, padding, dilation, groups
        ctx.shapes = x.shape, w.shape
        return F.conv2d(x16.to(x.dtype), w16.to(w.dtype), None, stride,
                        padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        dt = g.dtype
        # an operand no requested gradient reads: a stand-in of its shape
        # that holds one zero (torch.nn.grad.conv2d_input passes one such)
        x = x16.to(dt) if x16 is not None else \
            g.new_zeros(1).expand(ctx.shapes[0])
        w = w16.to(dt) if w16 is not None else \
            g.new_zeros(1).expand(ctx.shapes[1])
        dx, dw, _ = torch.ops.aten.convolution_backward(
            round_bf16(g), x, w, None, stride, padding, dilation, False,
            [0, 0], groups, [need_x, need_w, False])
        return dx, dw, None, None, None, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)``; under the mode, of bf16-rounded operands."""
    if not _BF16.get():
        return torch.matmul(a, b)
    return _Matmul.apply(a, b)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``F.linear(x, w, b)``; under the mode, ``x @ w^T`` of bf16-rounded
    operands, then the float32 bias."""
    if not _BF16.get():
        return F.linear(x, w, b)
    y = _Matmul.apply(x, w.t())
    return y if b is None else y + b


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` (zero padding given as numbers); under the mode, of
    bf16-rounded operands, then the float32 bias."""
    if not _BF16.get():
        return F.conv2d(x, w, b, stride, padding, dilation, groups)
    y = _Conv2d.apply(x, w, list(_pair(stride)), list(_pair(padding)),
                      list(_pair(dilation)), groups)
    return y if b is None else y + b.view(1, -1, 1, 1)
