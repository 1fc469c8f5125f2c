"""The plain FPN concat-conv of the port (robseg_torch/kernels/fpn_conv.py)
against the pure-JAX oracle ``fpn_concat_conv_reference``, on the CPU.

The port's plain version rounds the operands to bf16 where the TPU kernel
does (x, w; and g = bf16(bf16(dy) * bf16(s)) in the backward). The oracle
computes in float32, so it is fed the operands pre-rounded, dy already a
bf16 value and s a power of two (then the rounding of g is exact): both
sides compute the same float32 function, held to atol 1e-5 with rtol
1e-5 forward and 1e-4 for the gradients, the bounds of
tests/test_kernels.py:378-382. The backward's rounding of g with any s is
held against the TPU kernel's own expression (fpn_conv.py:95-98) in JAX.
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). What the kernel reads is held
here: an implicit GEMM written in the kernel's order (its plan's tiles,
(source, tap, 64-channel slice) K-steps over the packed weight panels, TMA
boxes zero-filled outside the tensors) equals the plain versions and the
JAX oracle at atol 1e-5 in float32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.fpn_conv import fpn_concat_conv_reference
from robseg_torch.kernels.fpn_conv import (TILE_K, TILE_M, TILE_N,
                                           fpn_concat_conv,
                                           fpn_concat_conv_dx_plain,
                                           fpn_concat_conv_fwd_plain,
                                           fpn_concat_conv_plain, plan,
                                           weight_panels)


def _bf(a: np.ndarray) -> np.ndarray:
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _case(seed, n, shape, co, s_any=False):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    w = (rng.standard_normal((n, 3, 3, shape[-1], co)) / 30).astype(
        np.float32)
    if s_any:
        s = (1 + 0.1 * rng.standard_normal(co)).astype(np.float32)
    else:
        s = rng.choice([0.5, 1.0, 2.0], co).astype(np.float32)
    t = (0.1 * rng.standard_normal(co)).astype(np.float32)
    dy = _bf(rng.standard_normal(shape[:-1] + (co,)).astype(np.float32))
    return xs, w, s, t, dy


# H = 19 and 9 are not multiples of the TPU kernel's row tile, C = 96 not
# a multiple of 128
@pytest.mark.parametrize("n,shape,co", [(4, (2, 19, 16, 96), 96),
                                        (2, (1, 9, 8, 64), 160)])
def test_plain_fwd_and_vjp_match_jax_reference(n, shape, co):
    xs, w, s, t, dy = _case(13, n, shape, co)
    want, vjp = jax.vjp(
        lambda *x: fpn_concat_conv_reference(x, jnp.asarray(_bf(w)),
                                             (jnp.asarray(s),
                                              jnp.asarray(t))),
        *[jnp.asarray(_bf(x)) for x in xs])
    want_dxs = vjp(jnp.asarray(dy))

    xt = [torch.tensor(x, requires_grad=True) for x in xs]
    out = fpn_concat_conv(xt, torch.tensor(w), torch.tensor(s),
                          torch.tensor(t))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    out.backward(torch.tensor(dy))
    for x, g in zip(xt, want_dxs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   atol=1e-5, rtol=1e-4)


def test_plain_dx_rounds_g_like_the_tpu_kernel():
    xs, w, s, t, dy = _case(5, 3, (1, 11, 7, 32), 64, s_any=True)
    out = fpn_concat_conv_plain([torch.tensor(x) for x in xs],
                                torch.tensor(w), torch.tensor(s),
                                torch.tensor(t))
    got = fpn_concat_conv_dx_plain(torch.tensor(dy), out, torch.tensor(w),
                                   torch.tensor(s))

    # robseg_tpu/kernels/fpn_conv.py:95-98 in bf16, then the transposed
    # conv of the concat with the bf16-rounded weight in float32
    bf = jnp.bfloat16
    mask = (jnp.asarray(out.numpy()) > 0).astype(bf)
    g = (jnp.asarray(dy).astype(bf) * mask
         * jnp.asarray(s).astype(bf)).astype(jnp.float32)
    n, _, _, c, co = w.shape
    wfull = jnp.asarray(_bf(w)).transpose(1, 2, 0, 3, 4).reshape(
        3, 3, n * c, co)
    xcat = jnp.zeros(dy.shape[:-1] + (n * c,), jnp.float32)
    dn = jax.lax.conv_dimension_numbers(xcat.shape, wfull.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(lambda z: jax.lax.conv_general_dilated(
        z, wfull, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn), xcat)
    want = np.asarray(vjp(g)[0])
    for i, dx in enumerate(got):
        np.testing.assert_allclose(dx.numpy(), want[..., i * c:(i + 1) * c],
                                   atol=1e-5, rtol=1e-4)


def test_no_parameter_gradients():
    xs, w, s, t, _ = _case(2, 2, (1, 5, 6, 32), 32)
    xt = [torch.tensor(x, requires_grad=True) for x in xs]
    params = [torch.tensor(a, requires_grad=True) for a in (w, s, t)]
    fpn_concat_conv(xt, *params).sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in xt)
    assert all(p.grad is None for p in params)


def _implicit_gemm(acts, panels, n, sign, slots, s=None, t=None):
    """csrc/fpn_conv.cu's GEMM in plain PyTorch, in the kernel's order.
    ``acts`` (k_src, B, H, W, ca) are the bf16-valued maps, ``panels`` (9 *
    (k_src + slots - 1), n, ca) the packed weights. Walks the plan's tiles
    (N innermost) and, in each, the (source, tap, 64-channel slice)
    K-steps; each operand is a box that is zero outside the tensor (the
    TMA fill: the conv's padding, the image edge, the channel and output
    tails)."""
    k_src, b, h, w, ca = acts.shape
    pl = plan(b, h, w, n, slots, sms=132)
    bw, bh = pl["box_w"], pl["box_h"]
    tx, ty, tn = -(-w // bw), -(-h // bh), -(-n // TILE_N)
    kc = -(-ca // TILE_K)
    # zero fill: one pixel before the image, a box after it, the channels
    # up to whole K-steps, the output channels up to whole tiles
    ap = F.pad(acts, (0, kc * TILE_K - ca, 1, bw + 1, 1, bh + 1))
    pp = F.pad(panels, (0, kc * TILE_K - ca, 0, tn * TILE_N - n))
    out = torch.zeros(slots, b, h, w, n)
    assert pl["tiles"] == slots * b * ty * tx * tn
    for tile in range(pl["tiles"]):
        nt, r = tile % tn, tile // tn
        px, r = r % tx, r // tx
        py, r = r % ty, r // ty
        bi, slot = r % b, r // b
        x0, y0, n0 = px * bw, py * bh, nt * TILE_N
        acc = torch.zeros(TILE_M, TILE_N)
        for src in range(k_src):
            for tap in range(9):
                x = x0 + sign * (tap % 3 - 1)
                y = y0 + sign * (tap // 3 - 1)
                for c in range(0, kc * TILE_K, TILE_K):
                    a = ap[src, bi, y + 1:y + 1 + bh, x + 1:x + 1 + bw,
                           c:c + TILE_K].reshape(TILE_M, TILE_K)
                    wb = pp[(slot + src) * 9 + tap, n0:n0 + TILE_N,
                            c:c + TILE_K]
                    acc += a @ wb.T
        v = acc.reshape(bh, bw, TILE_N)
        if s is not None:
            v = torch.relu(v * F.pad(s, (0, tn * TILE_N - n))[n0:n0 + TILE_N]
                           + F.pad(t, (0, tn * TILE_N - n))[n0:n0 + TILE_N])
        hh, ww, nn = min(bh, h - y0), min(bw, w - x0), min(TILE_N, n - n0)
        out[slot, bi, y0:y0 + hh, x0:x0 + ww, n0:n0 + nn] = v[:hh, :ww, :nn]
    return out


# C = 96: a channel tail against 64-channel K-steps; Co = 160: an output
# tail against 256-wide tiles; W = 10: two 16 x 8 boxes per image
@pytest.mark.parametrize("n,shape,co", [(3, (1, 9, 10, 96), 160),
                                        (1, (1, 9, 10, 64), 96)])
def test_kernel_order_gemm_matches_plain_and_jax(n, shape, co):
    xs, w, s, t, dy = _case(7, n, shape, co)
    xt = [torch.tensor(x) for x in xs]
    wt, st, tt = torch.tensor(w), torch.tensor(s), torch.tensor(t)
    acts = torch.stack([x.to(torch.bfloat16).float() for x in xt])
    got = _implicit_gemm(acts, weight_panels(wt, False).float().reshape(
        n * 9, co, shape[-1]), co, 1, 1, st, tt)[0]
    want = fpn_concat_conv_fwd_plain(xt, wt, st, tt)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    oracle, vjp = jax.vjp(
        lambda *x: fpn_concat_conv_reference(x, jnp.asarray(_bf(w)),
                                             (jnp.asarray(s),
                                              jnp.asarray(t))),
        *[jnp.asarray(_bf(x)) for x in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)

    dyt = torch.tensor(dy)
    g = (dyt.to(torch.bfloat16) * st.to(torch.bfloat16)).float() * (want > 0)
    got = _implicit_gemm(g[None], weight_panels(wt, True).float().reshape(
        n * 9, shape[-1], co), shape[-1], -1, n)
    want = fpn_concat_conv_dx_plain(dyt, want, wt, st)
    for i, (a, e, o) in enumerate(zip(got, want, vjp(jnp.asarray(dy)))):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(o), atol=1e-5,
                                   rtol=1e-4)


def test_weight_panels_are_k_major_per_tap():
    w = torch.randn(2, 3, 3, 64, 96)
    fwd, dx = weight_panels(w, False), weight_panels(w, True)
    assert fwd.dtype == dx.dtype == torch.bfloat16
    assert fwd.is_contiguous() and dx.is_contiguous()
    # forward: (source, ky, kx) panels of (N = Co, K = C)
    assert fwd.shape == (2, 3, 3, 96, 64)
    assert torch.equal(fwd[1, 2, 0, 5, 7], w[1, 2, 0, 7, 5].to(torch.bfloat16))
    # input gradient: (N = C, K = Co), the weight as stored
    assert torch.equal(dx, w.to(torch.bfloat16))


@pytest.mark.parametrize("b,h,w,n,slots,want", [
    # batch 16 at 512^2: 128 x 1 boxes, N innermost in 2 tiles of 256
    (16, 128, 128, 512, 1, (128, 1, 4096, 132)),
    (16, 128, 128, 512, 4, (128, 1, 16384, 132)),
    # the ragged 473^2 crop: 119 rows of one 128 x 1 box
    (2, 119, 119, 512, 1, (128, 1, 476, 132)),
    # a map smaller than one box; W = 64: 64 x 2 boxes
    (1, 8, 9, 160, 1, (16, 8, 1, 1)),
    (8, 64, 64, 64, 1, (64, 2, 256, 132)),
    # 72 x 40: 5 x 5 boxes of 16 x 8 (40 of 128 x 1)
    (3, 40, 72, 160, 1, (16, 8, 75, 75)),
])
def test_plan_tiles(b, h, w, n, slots, want):
    pl = plan(b, h, w, n, slots, sms=132)
    assert (pl["box_w"], pl["box_h"], pl["tiles"], pl["blocks"]) == want
    assert pl["box_w"] * pl["box_h"] == TILE_M
    assert pl["tiles_per_block"] == -(-pl["tiles"] // pl["blocks"])
