"""The ConvNeXt block's MLP tail: CUDA forward and input-gradient kernels,
their plain versions, and the autograd Function that joins them.

Port of ``robseg_tpu/kernels/convnext_mlp.py`` (``convnext_mlp_fused``,
``_rs``, ``_bf16``, ``_rs_bf16``); the kernels are
``robseg_torch/csrc/convnext_mlp.cu`` (bf16 operands: the block's MLP
kernels of ``convnext_mlp.cuh`` behind a LayerNorm prologue) and
``convnext_mlp_f32.cu`` (float32 operands: two 3xTF32 GEMMs through an
f32 ``h``).

    m = gamma * (W2 . GELU(W1 . LN(y) + b1) + b2)

without the residual (the caller adds it). ``y`` is channels-last
``(B, H, W, C)`` float32; the parameters come in the layout of the
reference ``state_dict``, as the block kernel takes them: ``w1 (4C, C)``,
``w2 (C, 4C)``, vectors ``(C,)`` or ``(4C,)``. Through ``convnext_mlp``,
``y`` and the parameters may also be bfloat16 (the ``--precision bf16``
model): they are upcast, which is exact, and the tail writes float32, as
JAX's does (``convnext_mlp.py:168, 278, 315``); the input gradient comes
back in ``y``'s dtype.

The four JAX entry points are the four ``MODES``: ``residual`` saves the
pre-GELU hidden ``h`` (N, 4C) f32 in the forward so the backward does two
matmuls; ``recompute`` saves nothing for the backward and recomputes
``h`` there; the ``_bf16`` modes round the matmul operands to bf16 where
the TPU kernel does (``mxu_bf16=True``), the others keep them in float32
(the kernels: 3xTF32, each operand split into a TF32 ``hi`` rounded to
nearest and the remainder ``lo``). The plain versions round at the same
places and no others.

The CUDA entry points pack the float32 parameters themselves, once a
call, into a scratch buffer the wrapper allocates (its size from
``robseg_convnext_mlp_scratch``).

Differentiable with respect to ``y`` only: parameters get ``None``, as the
JAX VJPs give them zeros.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from robseg_torch.kernels import _build

LN_EPS = 1e-6
# mode -> (save_h, bf16_operands)
MODES = {"residual": (True, False), "recompute": (False, False),
         "residual_bf16": (True, True), "recompute_bf16": (False, True)}


# the float32 kernels' tiling (csrc/convnext_mlp_f32.cu): 128-token tiles
# and 32-deep K-steps, each step's three TF32 passes summed apart and then
# added to the tile's f32 sum; 128-wide output tiles, 96-wide for the
# C-wide products at C = 96 and 192. The bf16 kernels tile as the block's
# (kernels/convnext_block.py).
TF32_TILE_M, TF32_K_STEP = 128, 32


def tf32_tile_n(n: int) -> int:
    """Output-tile width of a 3xTF32 product with ``n`` columns."""
    return 96 if n % 128 else 128


def _op(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matmul operand as the kernel sees it."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _layer_norm(y, ls, lb):
    mean = y.mean(-1, keepdim=True)
    d = y - mean
    inv = torch.rsqrt((d * d).mean(-1, keepdim=True) + LN_EPS)
    xhat = d * inv
    return xhat, inv, xhat * ls + lb


def convnext_mlp_fwd_plain(y, ls, lb, w1, b1, w2, b2, gamma, save_h=False,
                           bf16_operands=False):
    """The tail in plain PyTorch ops. Returns ``(m, h)``; ``h`` is the
    pre-GELU hidden as ``(N, 4C)`` when ``save_h``, else ``None``."""
    _, _, u = _layer_norm(y, ls, lb)
    h = F.linear(_op(u, bf16_operands), _op(w1, bf16_operands)) + b1
    a = F.gelu(h, approximate="none")
    m = gamma * (F.linear(_op(a, bf16_operands), _op(w2, bf16_operands))
                 + b2)
    return m, (h.reshape(-1, h.shape[-1]) if save_h else None)


def convnext_mlp_dx_plain(y, gout, ls, lb, w1, b1, w2, gamma, h=None,
                          bf16_operands=False):
    """Input gradient of :func:`convnext_mlp_fwd_plain` in plain ops, in
    the order of the TPU kernel's ``_bwd_kernel``/``_bwd_resid_kernel``
    (the hidden recomputed, or ``h`` read when given)."""
    xhat, inv, u = _layer_norm(y, ls, lb)
    if h is None:
        h = F.linear(_op(u, bf16_operands), _op(w1, bf16_operands)) + b1
    else:
        h = h.reshape(*y.shape[:-1], w1.shape[0])
    da = _op(gout * gamma, bf16_operands) @ _op(w2, bf16_operands)
    cdf = 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * h * h) / math.sqrt(2 * math.pi)
    dh = da * (cdf + h * pdf)
    dxhat = (_op(dh, bf16_operands) @ _op(w1, bf16_operands)) * ls
    s1 = dxhat.mean(-1, keepdim=True)
    s2 = (dxhat * xhat).mean(-1, keepdim=True)
    return inv * (dxhat - s1 - xhat * s2)


def _kernel_args(y, ls, lb, w1, b1, w2, gamma, b2=None):
    """Check the operands; the kernels take the parameters as they are
    stored, float32, and pack them themselves. Returns the library and the
    parameters, contiguous (the caller keeps them alive over the launch)."""
    if (not y.is_cuda or y.dtype != torch.float32 or not y.is_contiguous()):
        raise ValueError("convnext_mlp: y must be a contiguous float32 "
                         f"(..., C) CUDA tensor; got {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}, "
                         f"contiguous={y.is_contiguous()}")
    c = y.shape[-1]
    lib = _build.library()
    if not lib.robseg_convnext_mlp_supported(c):
        raise ValueError(f"convnext_mlp: no kernel for C={c}")
    expect = {"ls": (ls, (c,)), "lb": (lb, (c,)), "w1": (w1, (4 * c, c)),
              "b1": (b1, (4 * c,)), "w2": (w2, (c, 4 * c)),
              "gamma": (gamma, (c,))}
    if b2 is not None:
        expect["b2"] = (b2, (c,))
    out = {}
    for name, (t, shape) in expect.items():
        if (t.device != y.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(
                f"convnext_mlp: {name} must be float32 {shape} on "
                f"{y.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
        out[name] = t if t.is_contiguous() else t.contiguous()
    return lib, out


def _scratch(lib, y, n, c, with_h, bf16_operands, backward):
    return torch.empty(lib.robseg_convnext_mlp_scratch(
        n, c, int(with_h), int(bf16_operands), int(backward)),
        dtype=torch.uint8, device=y.device)


def convnext_mlp_fwd_cuda(y, ls, lb, w1, b1, w2, b2, gamma, save_h=False,
                          bf16_operands=False):
    """Forward kernels on CUDA tensors; returns ``(m, h or None)``."""
    lib, k = _kernel_args(y, ls, lb, w1, b1, w2, gamma, b2=b2)
    c = y.shape[-1]
    n = y.numel() // c
    out = torch.empty_like(y)
    h = (torch.empty((n, 4 * c), dtype=torch.float32, device=y.device)
         if save_h else None)
    scratch = _scratch(lib, y, n, c, save_h, bf16_operands, False)
    err = lib.robseg_convnext_mlp_fwd(
        y.data_ptr(), k["ls"].data_ptr(), k["lb"].data_ptr(),
        k["w1"].data_ptr(), k["b1"].data_ptr(), k["w2"].data_ptr(),
        k["b2"].data_ptr(), k["gamma"].data_ptr(), scratch.data_ptr(),
        out.data_ptr(), None if h is None else h.data_ptr(), n, c,
        int(bf16_operands), torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "convnext_mlp_fwd")
    convnext_mlp_fwd_cuda.launches += 1
    return out, h


convnext_mlp_fwd_cuda.launches = 0


def convnext_mlp_dx_cuda(y, gout, ls, lb, w1, b1, w2, gamma, h=None,
                         bf16_operands=False):
    """Input-gradient kernels on CUDA tensors (``h``: the forward's saved
    hidden, or ``None`` to recompute it)."""
    lib, k = _kernel_args(y, ls, lb, w1, b1, w2, gamma)
    c = y.shape[-1]
    n = y.numel() // c
    if (gout.shape != y.shape or gout.dtype != torch.float32
            or gout.device != y.device):
        raise ValueError("convnext_mlp_dx: gout must match y")
    if h is not None and (tuple(h.shape) != (n, 4 * c)
                          or h.dtype != torch.float32
                          or h.device != y.device or not h.is_contiguous()):
        raise ValueError(f"convnext_mlp_dx: h must be a contiguous float32 "
                         f"({n}, {4 * c}) tensor on {y.device}")
    gout = gout.contiguous()
    dx = torch.empty_like(y)
    scratch = _scratch(lib, y, n, c, h is not None, bf16_operands, True)
    err = lib.robseg_convnext_mlp_dx(
        y.data_ptr(), None if h is None else h.data_ptr(), gout.data_ptr(),
        k["ls"].data_ptr(), k["lb"].data_ptr(), k["w1"].data_ptr(),
        k["b1"].data_ptr(), k["w2"].data_ptr(), k["gamma"].data_ptr(),
        scratch.data_ptr(), dx.data_ptr(), n, c, int(bf16_operands),
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "convnext_mlp_dx")
    convnext_mlp_dx_cuda.launches += 1
    return dx


convnext_mlp_dx_cuda.launches = 0


class ConvNeXtMlpFn(torch.autograd.Function):
    """Forward and input gradient through the kernels (``use_kernel``) or
    the plain versions; ``None`` for every parameter."""

    @staticmethod
    def forward(ctx, use_kernel, save_h, bf16, y, ls, lb, w1, b1, w2, b2,
                gamma):
        ctx.y_dtype = y.dtype
        y, ls, lb, w1, b1, w2, b2, gamma = (
            t.float() for t in (y, ls, lb, w1, b1, w2, b2, gamma))
        fwd = convnext_mlp_fwd_cuda if use_kernel else convnext_mlp_fwd_plain
        out, h = fwd(y, ls, lb, w1, b1, w2, b2, gamma, save_h=save_h,
                     bf16_operands=bf16)
        ctx.use_kernel, ctx.bf16 = use_kernel, bf16
        ctx.save_for_backward(y, ls, lb, w1, b1, w2, gamma,
                              *([h] if save_h else []))
        return out

    @staticmethod
    def backward(ctx, gout):
        y, ls, lb, w1, b1, w2, gamma, *h = ctx.saved_tensors
        fn = convnext_mlp_dx_cuda if ctx.use_kernel else convnext_mlp_dx_plain
        dx = fn(y, gout.contiguous(), ls, lb, w1, b1, w2, gamma,
                h=h[0] if h else None, bf16_operands=ctx.bf16)
        return (None, None, None, dx.to(ctx.y_dtype)) + (None,) * 7


def convnext_mlp(y, ls, lb, w1, b1, w2, b2, gamma, mode="residual"):
    """The tail on channels-last ``y`` in one of ``MODES``; CUDA tensors go
    through the kernels, CPU tensors through the plain versions."""
    save_h, bf16 = MODES[mode]
    return ConvNeXtMlpFn.apply(y.is_cuda, save_h, bf16, y, ls, lb, w1, b1,
                               w2, b2, gamma)


def convnext_mlp_plain(y, ls, lb, w1, b1, w2, b2, gamma, mode="residual"):
    """The same function through the plain versions on any device."""
    save_h, bf16 = MODES[mode]
    return ConvNeXtMlpFn.apply(False, save_h, bf16, y, ls, lb, w1, b1, w2,
                               b2, gamma)
