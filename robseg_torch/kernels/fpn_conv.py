"""UperNet's fpn_bottleneck without the channel concat: CUDA forward and
input-gradient kernels, their plain versions, and the autograd Function
that joins them.

Port of ``robseg_tpu/kernels/fpn_conv.py::fpn_concat_conv``; the kernels
are ``robseg_torch/csrc/fpn_conv.cu``.

    out = relu((sum_i conv3x3(bf16(x_i), bf16(w_i))) * s + t)

The layouts are the JAX function's: ``xs`` a list of n <= 4 channels-last
``(B, H, W, C)`` maps, all float32 or all bfloat16 (the ``--precision
bf16`` model), ``w`` the per-source weight slices ``(n, 3, 3, C, Co)``
(float32 or bfloat16), ``s, t`` the ``(Co,)`` float32 fold of the eval
BatchNorm. ``out`` and the input gradients are in the maps' dtype (JAX's
``fpn_concat_conv(..., out_dtype)`` as the model calls it, with
``fpn_outs[0].dtype``, and its ``in_dtypes``). Matmul operands are rounded
to bf16 and products summed in float32, where the TPU kernel rounds
(``fpn_conv.py:54-60, 93-98, 135``); the backward rounds ``g =
bf16(bf16(dy) * bf16(s)) * (out > 0)``. The plain versions round at the
same places (``.to(torch.bfloat16).float()``), convolve in float32 and
round once to the output dtype, so the kernel can be held to them
tightly. The bf16 form computes bit for bit what the float32 form
computes on the upcast maps, rounded once at the store; the forms count
their launches apart (``fpn_concat_conv_fwd_cuda`` and ``_dx_cuda`` for
float32 maps, ``fpn_concat_conv_fwd_bf16_cuda`` and ``_dx_bf16_cuda`` for
bf16 ones).

Differentiable with respect to ``xs`` only: ``w``, ``s`` and ``t`` are
attack-time constants and get ``None``, as the JAX VJP gives them zeros.

The kernels are one implicit GEMM (M = pixels, N = output channels, K =
(source, tap, 64-channel slice)) that reads its operands through TMA:
``weight_panels`` packs the weights into the bf16 panels it reads, and
``plan`` is its persistent schedule (the spatial box of a 128-pixel tile
and the number of blocks), which the wrappers pass to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from robseg_torch.kernels import _build


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _full_weight(w: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3, C, Co) slices -> the (Co, n*C, 3, 3) conv weight."""
    n, _, _, c, co = w.shape
    return w.permute(4, 0, 3, 1, 2).reshape(co, n * c, 3, 3)


def fpn_concat_conv_fwd_plain(xs, w, s, t):
    """The forward in plain PyTorch ops (concat, conv, affine, ReLU), in
    the dtype of the maps."""
    x = torch.cat([_bf(v) for v in xs], dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(x, _bf(_full_weight(w)), padding=1)
    y = F.relu(y * s[:, None, None] + t[:, None, None])
    return y.permute(0, 2, 3, 1).to(xs[0].dtype).contiguous()


def fpn_concat_conv_dx_plain(dy, out, w, s):
    """The input gradients of all sources, in plain PyTorch ops, in the
    dtype of ``dy``."""
    g = (dy.to(torch.bfloat16) * s.to(torch.bfloat16)).float() * (out > 0)
    dx = F.conv_transpose2d(g.permute(0, 3, 1, 2), _bf(_full_weight(w)),
                            padding=1)
    c = w.shape[3]
    return tuple(dx[:, i * c:(i + 1) * c].permute(0, 2, 3, 1)
                 .to(dy.dtype).contiguous() for i in range(w.shape[0]))


# the kernel's tile (csrc/fpn_conv.cu): 128 pixels by 256 output channels,
# K-steps of 64 channels through a 4-stage TMA ring
TILE_M, TILE_N, TILE_K, STAGES = 128, 256, 64, 4


def weight_panels(w: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The bf16 weight panels the kernel reads: for each (source, tap) an
    (N, K) matrix with K contiguous. Forward (N = Co, K = C):
    ``(n, 3, 3, Co, C)``; input gradient (``transpose``, N = C, K = Co):
    the weight as stored, ``(n, 3, 3, C, Co)``."""
    wb = w.detach().to(torch.bfloat16)
    return (wb if transpose else wb.transpose(3, 4)).contiguous()


def plan(b: int, h: int, w: int, n: int, slots: int, sms: int) -> dict:
    """The kernel's persistent schedule. A tile is a ``box_w x box_h`` =
    128-pixel patch of one image by 256 output channels; ``box_w`` is the
    power of two in 8..128 that needs the fewest tiles (the widest on a
    tie). Tiles walk (output slot, image, patch row, patch column, N tile),
    N innermost, strided over ``blocks = min(sms, tiles)`` blocks."""
    def patches(bw):
        return -(-w // bw) * -(-h // (TILE_M // bw))

    box_w = min((128, 64, 32, 16, 8), key=patches)
    tiles = slots * b * patches(box_w) * -(-n // TILE_N)
    blocks = max(1, min(sms, tiles))
    return {"box_w": box_w, "box_h": TILE_M // box_w, "tiles": tiles,
            "blocks": blocks, "tiles_per_block": -(-tiles // blocks)}


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, t: torch.Tensor, shape, device, dtypes=(torch.float32,),
           contiguous: bool = True) -> None:
    if (not t.is_cuda or t.device != device or t.dtype not in dtypes
            or tuple(t.shape) != tuple(shape)
            or (contiguous and (not t.is_contiguous() or t.data_ptr() % 16))):
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(
            f"fpn_concat_conv: {name} must be a contiguous, 16-byte aligned "
            f"{want} {tuple(shape)} CUDA tensor on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


IO_DTYPES = (torch.float32, torch.bfloat16)


def _shapes(x0: torch.Tensor, w: torch.Tensor):
    if not x0.is_cuda or x0.ndim != 4:
        raise ValueError("fpn_concat_conv: inputs must be (B, H, W, C) CUDA "
                         f"tensors; got {tuple(x0.shape)} on {x0.device}")
    n, c, co = w.shape[0], w.shape[3], w.shape[4]
    if not 1 <= n <= 4 or c % 32 or co % 32:
        raise ValueError(f"fpn_concat_conv: no kernel for {n} sources, "
                         f"C={c}, Co={co} (1-4 sources, C and Co multiples "
                         "of 32)")
    # any strides: the wrappers pack it into panels
    _check("w", w, (n, 3, 3, c, co), x0.device, IO_DTYPES, contiguous=False)
    return n, c, co


def _fwd(counter, io_dtype, xs, w, s, t):
    xs = list(xs)
    n, c, co = _shapes(xs[0], w)
    b, h, wd, _ = xs[0].shape
    if len(xs) != n:
        raise ValueError(f"fpn_concat_conv: {len(xs)} inputs, {n} weights")
    dev = xs[0].device
    for i, x in enumerate(xs):
        _check(f"xs[{i}]", x, (b, h, wd, c), dev, (io_dtype,))
    _check("s", s, (co,), dev)
    _check("t", t, (co,), dev)
    wp = weight_panels(w, transpose=False)
    pl = plan(b, h, wd, co, 1, _sms(dev))
    bf16 = io_dtype == torch.bfloat16
    # float32 maps are written once as bf16 for the GEMM; bf16 maps are
    # read where they lie
    xb = None if bf16 else torch.empty((n, b, h, wd, c), dtype=torch.bfloat16,
                                       device=dev)
    out = torch.empty((b, h, wd, co), dtype=io_dtype, device=dev)
    ptrs = [x.data_ptr() for x in xs] + [None] * (4 - n)
    err = _build.library().robseg_fpn_fwd(
        *ptrs, n, wp.data_ptr(), s.data_ptr(), t.data_ptr(),
        None if xb is None else xb.data_ptr(), out.data_ptr(), b, h, wd, c,
        co, int(bf16), pl["box_w"], pl["blocks"],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out


def _dx(counter, io_dtype, dy, out, w, s):
    n, c, co = _shapes(dy, w)
    b, h, wd, _ = dy.shape
    _check("dy", dy, (b, h, wd, co), dy.device, (io_dtype,))
    _check("out", out, (b, h, wd, co), dy.device, (io_dtype,))
    _check("s", s, (co,), dy.device)
    wt = weight_panels(w, transpose=True)
    pl = plan(b, h, wd, c, n, _sms(dy.device))
    g = torch.empty((b, h, wd, co), dtype=torch.bfloat16, device=dy.device)
    dxs = [torch.empty((b, h, wd, c), dtype=io_dtype, device=dy.device)
           for _ in range(n)]
    ptrs = [d.data_ptr() for d in dxs] + [None] * (4 - n)
    err = _build.library().robseg_fpn_dx(
        dy.data_ptr(), out.data_ptr(), wt.data_ptr(), s.data_ptr(),
        g.data_ptr(), *ptrs, n, b, h, wd, c, co,
        int(io_dtype == torch.bfloat16), pl["box_w"], pl["blocks"],
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, counter.__name__)
    counter.launches += 1
    return tuple(dxs)


def fpn_concat_conv_fwd_cuda(xs, w, s, t):
    """Forward kernel on float32 CUDA maps."""
    return _fwd(fpn_concat_conv_fwd_cuda, torch.float32, xs, w, s, t)


def fpn_concat_conv_fwd_bf16_cuda(xs, w, s, t):
    """The forward kernel's bf16 form: bfloat16 maps and output."""
    return _fwd(fpn_concat_conv_fwd_bf16_cuda, torch.bfloat16, xs, w, s, t)


def fpn_concat_conv_dx_cuda(dy, out, w, s):
    """Input-gradient kernel on float32 CUDA tensors: one launch writes the
    gradients of all sources."""
    return _dx(fpn_concat_conv_dx_cuda, torch.float32, dy, out, w, s)


def fpn_concat_conv_dx_bf16_cuda(dy, out, w, s):
    """The input-gradient kernel's bf16 form: ``dy``, ``out`` and the
    gradients bfloat16."""
    return _dx(fpn_concat_conv_dx_bf16_cuda, torch.bfloat16, dy, out, w, s)


for _fn in (fpn_concat_conv_fwd_cuda, fpn_concat_conv_fwd_bf16_cuda,
            fpn_concat_conv_dx_cuda, fpn_concat_conv_dx_bf16_cuda):
    _fn.launches = 0
# the kernel forms by the dtype of the maps
_FWD_CUDA = {torch.float32: fpn_concat_conv_fwd_cuda,
             torch.bfloat16: fpn_concat_conv_fwd_bf16_cuda}
_DX_CUDA = {torch.float32: fpn_concat_conv_dx_cuda,
            torch.bfloat16: fpn_concat_conv_dx_bf16_cuda}


class FpnConcatConvFn(torch.autograd.Function):
    """Forward and input gradients through the kernels (``use_kernel``) or
    the plain versions; ``None`` for ``w``, ``s`` and ``t``."""

    @staticmethod
    def forward(ctx, use_kernel, w, s, t, *xs):
        fwd = _FWD_CUDA.get(xs[0].dtype, fpn_concat_conv_fwd_cuda) \
            if use_kernel else fpn_concat_conv_fwd_plain
        out = fwd(list(xs), w, s, t)
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(w, s, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        w, s, out = ctx.saved_tensors
        dx = _DX_CUDA.get(dy.dtype, fpn_concat_conv_dx_cuda) \
            if ctx.use_kernel else fpn_concat_conv_dx_plain
        return (None, None, None, None) + tuple(dx(dy.contiguous(), out, w,
                                                   s))


def fpn_concat_conv(xs, w, s, t):
    """The bottleneck on channels-last ``xs``; CUDA tensors go through the
    kernels, CPU tensors through the plain versions."""
    return FpnConcatConvFn.apply(xs[0].is_cuda, w, s, t, *xs)


def fpn_concat_conv_plain(xs, w, s, t):
    """The same function through the plain versions on any device."""
    return FpnConcatConvFn.apply(False, w, s, t, *xs)
