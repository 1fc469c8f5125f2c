"""The whole ConvNeXt block: CUDA forward and input-gradient kernels, their
plain versions, and the autograd Function that joins them.

Port of ``robseg_tpu/kernels/convnext_block.py``: one implementation serves
both JAX entry points, ``convnext_block_fused`` (stages 0-1) and
``convnext_block_fused_whole`` (stages 2-3). The kernels are
``robseg_torch/csrc/convnext_block.cu``.

    out = x + gamma * (W2 . GELU(W1 . LN(dwconv7x7(x) + dwb) + b1) + b2)

``x`` is channels-last ``(B, H, W, C)``, as the JAX kernels take it,
float32 or bfloat16 (the ``--precision bf16`` model); ``out`` and ``dx``
are in ``x``'s dtype. The parameters come in the layout of the reference
``state_dict``: ``dw (C, 1, 7, 7)``, ``w1 (4C, C)``, ``w2 (C, 4C)``,
vectors ``(C,)`` or ``(4C,)``, all float32 or all bfloat16. The CUDA entry
points pack them once per call into what the kernels read (depthwise taps
``(49, C)`` f32; bf16 K-major panels ``W1``, ``W2``, and for the backward
``W2^T`` and ``W1^T``; bf16 vectors upcast to f32) in the one scratch
buffer the wrapper allocates.

The bf16 form computes in float32 inside, exactly as the float32 form on
the upcast inputs, and rounds ``out`` / ``dx`` once (the JAX kernel's
contract: "f32 internal math (bf16 I/O ok)"). The forms count their
launches apart: ``convnext_block_fwd_cuda`` / ``convnext_block_dx_cuda``
(float32 I/O) and ``convnext_block_fwd_bf16_cuda`` /
``convnext_block_dx_bf16_cuda`` (bf16 I/O).

The MLP runs in one of two forms (``fused``): at ``C <= FUSED_MAX_C`` one
kernel keeps the 4C hidden layer on chip, walking ``TILE_M``-token tiles
and ``HIDDEN_CHUNK``-wide hidden chunks; above it two GEMMs pass the
hidden layer through device memory in bf16 (``(B*H*W, 4C)`` scratch),
``TILE_M x TILE_N`` tiles with ``HIDDEN_CHUNK``-deep K-steps. Both round
where the TPU kernel rounds, so they compute the same function.

The block is differentiable with respect to ``x`` only: parameters are
attack-time constants and get no gradient (``None``), exactly as the JAX
VJP gives them zeros. The model calls this only in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from robseg_torch.kernels import _build

LN_EPS = 1e-6


def convnext_block_plain(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """The block in plain PyTorch ops, in float32 on the upcast inputs,
    rounded once to the dtype of ``x``."""
    c = x.shape[-1]
    x32 = x.float()
    dw, dwb, ls, lb, w1, b1, w2, b2, gamma = (
        t.float() for t in (dw, dwb, ls, lb, w1, b1, w2, b2, gamma))
    y = F.conv2d(x32.permute(0, 3, 1, 2), dw, dwb, padding=3, groups=c)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), ls, lb, LN_EPS)
    h = F.gelu(F.linear(y, w1, b1), approximate="none")
    return (x32 + gamma * F.linear(h, w2, b2)).to(x.dtype)


def convnext_block_dx_plain(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Input gradient of :func:`convnext_block_plain` by autograd, in
    float32 on the upcast inputs, rounded once to the dtype of ``x``."""
    params = [p.detach() for p in (dw, dwb, ls, lb, w1, b1, w2, b2, gamma)]
    with torch.enable_grad():
        xg = x.detach().float().requires_grad_(True)
        out = convnext_block_plain(xg, *params)
        (dx,) = torch.autograd.grad(out, xg, dy.float())
    return dx.to(x.dtype)


# the kernels' tiling (csrc/convnext_block.cu): 128-token tiles, 64-wide
# hidden chunks and K-steps, 128 x 128 output tiles in the two-GEMM form
FUSED_MAX_C = 192
TILE_M, TILE_N, HIDDEN_CHUNK = 128, 128, 64


def fused(c: int) -> bool:
    """Whether width ``c`` runs the fused MLP kernel (hidden layer on
    chip) or the two GEMMs through a bf16 hidden layer."""
    return c <= FUSED_MAX_C


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


IO_DTYPES = (torch.float32, torch.bfloat16)


def _operands(x, params, names, io_dtype):
    """Check the operands (the kernels take the parameters as they are
    stored, all float32 or all bfloat16, and pack them themselves) and
    return the library, the parameters, contiguous (the caller keeps them
    alive over the launch), and whether they are bf16."""
    if (not x.is_cuda or x.ndim != 4 or x.dtype != io_dtype
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"convnext_block: x must be a contiguous {io_dtype} "
                         f"(B, H, W, C) CUDA tensor, 16-byte aligned; got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"contiguous={x.is_contiguous()}")
    c = x.shape[-1]
    lib = _build.library()
    if not lib.robseg_convnext_block_supported(c):
        raise ValueError(f"convnext_block: no kernel for C={c}")
    shapes = {"dw": (c, 1, 7, 7), "w1": (4 * c, c), "b1": (4 * c,),
              "w2": (c, 4 * c)}
    dev = x.get_device()
    p_dtype = params[0].dtype
    out = []
    for name, t in zip(names, params):
        shape = shapes.get(name, (c,))
        if (t.get_device() != dev or t.dtype != p_dtype
                or p_dtype not in IO_DTYPES or t.shape != shape):
            raise ValueError(
                f"convnext_block: {name} must be {p_dtype} (every parameter "
                f"float32, or every one bfloat16) {shape} on {x.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t if t.is_contiguous() else t.contiguous())
    return lib, out, p_dtype == torch.bfloat16


_FWD_NAMES = ("dw", "dwb", "ls", "lb", "w1", "b1", "w2", "b2", "gamma")
_DX_NAMES = ("dw", "dwb", "ls", "lb", "w1", "b1", "w2", "gamma")


def _fwd(counter, io_dtype, x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    lib, params, p_bf16 = _operands(
        x, (dw, dwb, ls, lb, w1, b1, w2, b2, gamma), _FWD_NAMES, io_dtype)
    b, h, w, c = x.shape
    scratch = torch.empty(lib.robseg_convnext_block_scratch(b, h, w, c, 0),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    err = lib.robseg_convnext_block_fwd(
        x.data_ptr(), *(t.data_ptr() for t in params), scratch.data_ptr(),
        out.data_ptr(), b, h, w, c, int(io_dtype == torch.bfloat16),
        int(p_bf16), _sms(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out


def _dx(counter, io_dtype, x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    del b2  # the gradient does not depend on it
    lib, params, p_bf16 = _operands(
        x, (dw, dwb, ls, lb, w1, b1, w2, gamma), _DX_NAMES, io_dtype)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("convnext_block_dx: dy must match x")
    dy = dy.contiguous()
    b, h, w, c = x.shape
    scratch = torch.empty(lib.robseg_convnext_block_scratch(b, h, w, c, 1),
                          dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    err = lib.robseg_convnext_block_dx(
        x.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in params),
        scratch.data_ptr(), dx.data_ptr(), b, h, w, c,
        int(io_dtype == torch.bfloat16), int(p_bf16), _sms(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, counter.__name__)
    counter.launches += 1
    return dx


def convnext_block_fwd_cuda(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Forward kernels (packing, dwconv+LN, then the MLP) on a float32
    CUDA tensor."""
    return _fwd(convnext_block_fwd_cuda, torch.float32, x, dw, dwb, ls, lb,
                w1, b1, w2, b2, gamma)


def convnext_block_fwd_bf16_cuda(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """The forward kernels' bf16 I/O form: ``x`` and ``out`` bfloat16."""
    return _fwd(convnext_block_fwd_bf16_cuda, torch.bfloat16, x, dw, dwb, ls,
                lb, w1, b1, w2, b2, gamma)


def convnext_block_dx_cuda(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Input-gradient kernels (packing, dwconv+LN recompute, MLP and LN
    backward, then the flipped 7x7 correlation) on float32 CUDA
    tensors."""
    return _dx(convnext_block_dx_cuda, torch.float32, x, dy, dw, dwb, ls, lb,
               w1, b1, w2, b2, gamma)


def convnext_block_dx_bf16_cuda(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2,
                                gamma):
    """The input-gradient kernels' bf16 I/O form: ``x``, ``dy`` and ``dx``
    bfloat16."""
    return _dx(convnext_block_dx_bf16_cuda, torch.bfloat16, x, dy, dw, dwb,
               ls, lb, w1, b1, w2, b2, gamma)


for _fn in (convnext_block_fwd_cuda, convnext_block_fwd_bf16_cuda,
            convnext_block_dx_cuda, convnext_block_dx_bf16_cuda):
    _fn.launches = 0
# the kernel forms by the dtype of x
_FWD_CUDA = {torch.float32: convnext_block_fwd_cuda,
             torch.bfloat16: convnext_block_fwd_bf16_cuda}
_DX_CUDA = {torch.float32: convnext_block_dx_cuda,
            torch.bfloat16: convnext_block_dx_bf16_cuda}


class ConvNeXtBlockFn(torch.autograd.Function):
    """Forward and input gradient of the block; ``None`` for every
    parameter. CUDA tensors go through the kernels, CPU tensors through the
    plain versions."""

    @staticmethod
    def forward(ctx, x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma)
        fn = _FWD_CUDA.get(x.dtype, _FWD_CUDA[torch.float32]) if x.is_cuda \
            else convnext_block_plain
        return fn(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        fn = _DX_CUDA.get(x.dtype, _DX_CUDA[torch.float32]) if x.is_cuda \
            else convnext_block_dx_plain
        return (fn(x, dy, *params),) + (None,) * len(params)


def convnext_block(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """The block on channels-last ``x``; differentiable in ``x`` only."""
    return ConvNeXtBlockFn.apply(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma)
