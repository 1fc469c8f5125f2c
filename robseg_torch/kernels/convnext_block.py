"""The whole ConvNeXt block: CUDA forward and input-gradient kernels, their
plain versions, and the autograd Function that joins them.

Port of ``robseg_tpu/kernels/convnext_block.py``: one implementation serves
both JAX entry points, ``convnext_block_fused`` (stages 0-1) and
``convnext_block_fused_whole`` (stages 2-3). The kernels are
``robseg_torch/csrc/convnext_block.cu``.

    out = x + gamma * (W2 . GELU(W1 . LN(dwconv7x7(x) + dwb) + b1) + b2)

``x`` is channels-last ``(B, H, W, C)`` float32, as the JAX kernels take it.
The parameters come in the layout of the reference ``state_dict``:
``dw (C, 1, 7, 7)``, ``w1 (4C, C)``, ``w2 (C, 4C)``, vectors ``(C,)`` or
``(4C,)``. The CUDA entry points pack them once per call into what the
kernels read (depthwise taps ``(49, C)`` f32; bf16 K-major panels ``W1``,
``W2``, and for the backward ``W2^T`` and ``W1^T``) in the one scratch
buffer the wrapper allocates.

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
    """The block in plain PyTorch ops, in the dtype of ``x``."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw, dwb, padding=3, groups=c)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), ls, lb, LN_EPS)
    h = F.gelu(F.linear(y, w1, b1), approximate="none")
    return x + gamma * F.linear(h, w2, b2)


def convnext_block_dx_plain(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Input gradient of :func:`convnext_block_plain` by autograd."""
    params = [p.detach() for p in (dw, dwb, ls, lb, w1, b1, w2, b2, gamma)]
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = convnext_block_plain(xg, *params)
        (dx,) = torch.autograd.grad(out, xg, dy)
    return dx


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


def _operands(x, params, names):
    """Check the operands (the kernels take the parameters as they are
    stored, float32, and pack them themselves) and return the library and
    the parameters, contiguous (the caller keeps them alive over the
    launch)."""
    if (not x.is_cuda or x.ndim != 4 or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("convnext_block: x must be a contiguous float32 "
                         f"(B, H, W, C) CUDA tensor; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, "
                         f"contiguous={x.is_contiguous()}")
    c = x.shape[-1]
    lib = _build.library()
    if not lib.robseg_convnext_block_supported(c):
        raise ValueError(f"convnext_block: no kernel for C={c}")
    shapes = {"dw": (c, 1, 7, 7), "w1": (4 * c, c), "b1": (4 * c,),
              "w2": (c, 4 * c)}
    dev = x.get_device()
    out = []
    for name, t in zip(names, params):
        shape = shapes.get(name, (c,))
        if (t.get_device() != dev or t.dtype != torch.float32
                or t.shape != shape):
            raise ValueError(
                f"convnext_block: {name} must be float32 {shape} on "
                f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t if t.is_contiguous() else t.contiguous())
    return lib, out


_FWD_NAMES = ("dw", "dwb", "ls", "lb", "w1", "b1", "w2", "b2", "gamma")
_DX_NAMES = ("dw", "dwb", "ls", "lb", "w1", "b1", "w2", "gamma")


def convnext_block_fwd_cuda(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Forward kernels (packing, dwconv+LN, then the MLP) on a CUDA
    tensor."""
    lib, params = _operands(x, (dw, dwb, ls, lb, w1, b1, w2, b2, gamma),
                            _FWD_NAMES)
    b, h, w, c = x.shape
    scratch = torch.empty(lib.robseg_convnext_block_scratch(b, h, w, c, 0),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    err = lib.robseg_convnext_block_fwd(
        x.data_ptr(), *(t.data_ptr() for t in params), scratch.data_ptr(),
        out.data_ptr(), b, h, w, c,
        _sms(x.device), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "convnext_block_fwd")
    convnext_block_fwd_cuda.launches += 1
    return out


convnext_block_fwd_cuda.launches = 0


def convnext_block_dx_cuda(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """Input-gradient kernels (packing, dwconv+LN recompute, MLP and LN
    backward, then the flipped 7x7 correlation) on CUDA tensors."""
    del b2  # the gradient does not depend on it
    lib, params = _operands(x, (dw, dwb, ls, lb, w1, b1, w2, gamma),
                            _DX_NAMES)
    if dy.shape != x.shape or dy.dtype != torch.float32 or dy.device != x.device:
        raise ValueError("convnext_block_dx: dy must match x")
    dy = dy.contiguous()
    b, h, w, c = x.shape
    scratch = torch.empty(lib.robseg_convnext_block_scratch(b, h, w, c, 1),
                          dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    err = lib.robseg_convnext_block_dx(
        x.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in params),
        scratch.data_ptr(), dx.data_ptr(),
        b, h, w, c, _sms(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "convnext_block_dx")
    convnext_block_dx_cuda.launches += 1
    return dx


convnext_block_dx_cuda.launches = 0


class ConvNeXtBlockFn(torch.autograd.Function):
    """Forward and input gradient of the block; ``None`` for every
    parameter. CUDA tensors go through the kernels, CPU tensors through the
    plain versions."""

    @staticmethod
    def forward(ctx, x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
        ctx.save_for_backward(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma)
        if x.is_cuda:
            return convnext_block_fwd_cuda(x, dw, dwb, ls, lb, w1, b1, w2,
                                           b2, gamma)
        return convnext_block_plain(x, dw, dwb, ls, lb, w1, b1, w2, b2,
                                    gamma)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        fn = convnext_block_dx_cuda if x.is_cuda else convnext_block_dx_plain
        return (fn(x, dy, *params),) + (None,) * len(params)


def convnext_block(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma):
    """The block on channels-last ``x``; differentiable in ``x`` only."""
    return ConvNeXtBlockFn.apply(x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma)
