"""The plain versions of the port's kernels against the pure-JAX functions.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances: the block
forward atol 5e-6 / rtol 1e-5 and its input gradient atol 1e-5 / rtol 1e-4
(the bounds of tests/test_kernels.py for float32 dots); the APGD step and
the confusion histogram exact.

What the block kernels compute is held here too: the block written in the
kernels' order (csrc/convnext_block.cu: the depthwise passes' tiles,
32-channel chunks and halo boxes zero-filled outside the image, 128-token
tiles zero-filled past the last token, 64-wide hidden chunks in the fused
form at C <= 192, 128 x 128 tiles with 64-deep K-steps through a bf16
hidden layer above it, K walked in 64-channel slabs) and rounded to bf16
exactly where the kernels round, against the float32 plain versions and
the JAX reference at the bf16 bounds of the card tests (forward atol =
rtol = 2e-2, input gradient max error <= 2e-2 of its largest entry). The
depthwise walk alone is held to F.conv2d at atol 1e-5 (float32, 49 terms
summed in another order).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.convnext_block import convnext_block_reference
from robseg_tpu.ops import metrics as jm
from robseg_tpu.ops.projections import project_linf as j_project_linf
from robseg_torch import kernels
from robseg_torch.kernels import convnext_block as cb
from robseg_torch.kernels.convnext_block import convnext_block

H100_SMS = 132  # the persistent grids' size on the H100


def _jax_params(rng, c):
    """JAX-layout block parameters (tests/test_kernels.py::_params)."""
    return [a.astype(np.float32) for a in (
        rng.normal(size=(7, 7, c)) * 0.1,        # dw
        rng.normal(size=c) * 0.1,                # dwb
        rng.random(c) + 0.5,                     # ls
        rng.normal(size=c) * 0.1,                # lb
        rng.normal(size=(c, 4 * c)) * 0.05,      # w1
        rng.normal(size=4 * c) * 0.1,            # b1
        rng.normal(size=(4 * c, c)) * 0.05,      # w2
        rng.normal(size=c) * 0.1,                # b2
        rng.random(c),                           # gamma
    )]


def _torch_params(p):
    """JAX layout -> the reference state_dict layout the port takes."""
    dw, dwb, ls, lb, w1, b1, w2, b2, g = p
    return [torch.tensor(a) for a in (
        np.ascontiguousarray(dw.transpose(2, 0, 1)[:, None]), dwb, ls, lb,
        np.ascontiguousarray(w1.T), b1, np.ascontiguousarray(w2.T), b2, g)]


@pytest.mark.parametrize("shape", [(2, 37, 20, 96), (1, 15, 15, 384)])
def test_block_plain_matches_jax_reference(shape):
    rng = np.random.default_rng(11)
    pj = _jax_params(rng, shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(convnext_block_reference(jnp.asarray(x), *pj))
    gw = np.asarray(jax.grad(
        lambda z: (convnext_block_reference(z, *pj) ** 2).sum())(
            jnp.asarray(x)))

    xt = torch.tensor(x, requires_grad=True)
    out = convnext_block(xt, *_torch_params(pj))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=5e-6,
                               rtol=1e-5)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gw, atol=1e-5, rtol=1e-4)


def test_block_fn_gives_no_parameter_gradients():
    rng = np.random.default_rng(2)
    params = [p.requires_grad_(True) for p in
              _torch_params(_jax_params(rng, 96))]
    x0 = rng.normal(size=(1, 9, 11, 96)).astype(np.float32)
    x = torch.tensor(x0, requires_grad=True)
    # a weight that requires grad makes the backward raise, none is filled
    with pytest.raises(RuntimeError, match="input gradients only"):
        convnext_block(x, *params).sum().backward()
    assert all(p.grad is None for p in params)
    x = torch.tensor(x0, requires_grad=True)
    convnext_block(x, *[p.detach() for p in params]).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _bf(t):
    return t.to(torch.bfloat16).float()


def _gelu_grad(v):
    return 0.5 * (1 + torch.erf(v * 0.7071067811865476)) + v * torch.exp(
        -0.5 * v * v) * 0.3989422804014327


def _k_steps(a, b, skip=True):
    """a . b^T over K as the kernels walk it: K zero-filled to a multiple
    of HIDDEN_CHUNK (a shared-memory slab of the token tile and of the
    weight panel each; TMA's fill), each slab four K16-deep wgmma steps,
    the steps' products summed in order. ``skip`` leaves out the steps
    that lie wholly in the fill (the C = 96 tail of the fused kernels), as
    the kernels do; without it, the zero-filled walk."""
    k = a.shape[1]
    steps = (cb.fused_h_steps(k) if skip else
             -(-k // cb.HIDDEN_CHUNK) * cb.HIDDEN_CHUNK // cb.K16)
    a, b = (F.pad(t, (0, steps * cb.K16 - k)).reshape(
        t.shape[0], steps, cb.K16) for t in (a, b))
    prods = torch.einsum("msk,nsk->smn", a, b)
    out = prods[0]
    for p in prods[1:]:
        out = out + p
    return out


def _gemm_tiles(a, b, bn=None):
    """a (m, k) . b (n, k)^T over TILE_M x bn output tiles, as
    mlp_gemm_kernel walks them (rows past m are TMA zero fill): TILE_N, or
    the forward's second GEMM's width from the plan (``gemm_bn`` on the
    H100's SMs)."""
    m, n = a.shape[0], b.shape[0]
    bn = bn or cb.TILE_N
    assert n % bn == 0
    a = F.pad(a, (0, 0, 0, -m % cb.TILE_M))
    out = torch.zeros(a.shape[0], n)
    for m0 in range(0, a.shape[0], cb.TILE_M):
        for n0 in range(0, n, bn):
            out[m0:m0 + cb.TILE_M, n0:n0 + bn] = _k_steps(
                a[m0:m0 + cb.TILE_M], b[n0:n0 + bn])
    return out[:m]


def _second_gemm(a, b):
    return _gemm_tiles(a, b, cb.gemm_bn(a.shape[0], b.shape[0], H100_SMS))


def _fused_tiles(toks, chunk):
    """mlp_fused_kernel's walk: TILE_M-token tiles (zero rows past the
    last token), and in each the 4C hidden units in HIDDEN_CHUNK-wide
    chunks; ``chunk(tiles, j)`` gives one chunk's contribution."""
    n, c = toks[0].shape
    toks = [F.pad(t, (0, 0, 0, -n % cb.TILE_M)) for t in toks]
    acc = torch.zeros(toks[0].shape[0], c)
    for t0 in range(0, acc.shape[0], cb.TILE_M):
        tile = [t[t0:t0 + cb.TILE_M] for t in toks]
        for j in range(0, 4 * c, cb.HIDDEN_CHUNK):
            acc[t0:t0 + cb.TILE_M] += chunk(tile, slice(
                j, j + cb.HIDDEN_CHUNK))
    return acc[:n]


def _dw_patches(th, tw, rh, rw):
    """The patch origins of the depthwise kernels' warps (warp w: row
    (w // (tw // rw)) rh, column (w % (tw // rw)) rw of the tile)."""
    wc = tw // rw
    return [((w // wc) * rh, (w % wc) * rw) for w in range(cb.DW_WARPS)]


def dw_walk(x, dw, flip=False):
    """The 7x7 depthwise conv of channels-last ``x`` with taps ``dw`` (C,
    1, 7, 7), or (``flip``) its correlation with the flipped taps, as the
    depthwise kernels walk it: TH x TW tiles (``DW_TILES`` by width), each
    warp an RH x RW patch of the tile, DW_CHUNK channels at a time, each
    chunk of a tile from one (TH + 6) x (TW + 6) halo box that starts 3
    pixels before the tile and is zero outside the tensor (the TMA fill:
    the padding and the ragged edge), every output summing its taps
    ky-major, kx-minor."""
    b, h, w, c = x.shape
    th, tw, rh, rw = cb.DW_TILES[c]
    cover = torch.zeros(th, tw, dtype=torch.int64)
    for ry, rx in _dw_patches(th, tw, rh, rw):
        cover[ry:ry + rh, rx:rx + rw] += 1
    assert bool((cover == 1).all()), "the warps' patches tile the tile"
    # the LayerNorm pass: L lanes a token, 4 channels a lane at a time
    lanes = 8 if th * tw >= 32 else 32 * cb.DW_WARPS // (th * tw)
    assert th * tw % (32 * cb.DW_WARPS // lanes) == 0
    assert c % (4 * lanes) == 0 and c % cb.DW_CHUNK == 0
    ty, tx = -(-h // th), -(-w // tw)
    xp = F.pad(x, (0, 0, 3, tx * tw - w + 3, 3, ty * th - h + 3))
    taps = dw[:, 0].flip(-1, -2) if flip else dw[:, 0]
    out = torch.zeros(b, ty, tx, th, tw, c)
    for c0 in range(0, c, cb.DW_CHUNK):
        # every tile's halo box of the chunk: (B, ty, tx, chunk, TH+6, TW+6)
        halo = xp[..., c0:c0 + cb.DW_CHUNK].unfold(1, th + 6, th).unfold(
            2, tw + 6, tw)
        k = taps[c0:c0 + cb.DW_CHUNK, :, :, None, None]
        acc = torch.zeros(halo.shape[:4] + (th, tw))
        for ky in range(7):
            for kx in range(7):
                acc += halo[..., ky:ky + th, kx:kx + tw] * k[:, ky, kx]
        out[..., c0:c0 + cb.DW_CHUNK] = acc.permute(0, 1, 2, 4, 5, 3)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(
        b, ty * th, tx * tw, c)[:, :h, :w]


def block_kernel_order(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, g):
    """The block's forward and input gradient as csrc/convnext_block.cu
    computes them, rounding to bf16 where the kernels round: u, W1, W2,
    gelu(h) (forward), gms = gamma * dy and dh (backward); the depthwise
    conv and correlation as ``dw_walk``."""
    c = x.shape[-1]
    y = (dw_walk(x, dw) + dwb).reshape(-1, c)
    d = y - y.mean(-1, keepdim=True)
    inv = torch.rsqrt((d * d).mean(-1, keepdim=True) + cb.LN_EPS)
    xhat = d * inv
    u = _bf(xhat * ls + lb)
    w1b, w2b = _bf(w1), _bf(w2)
    if cb.fused(c):
        mlp = _fused_tiles([u], lambda t, j: _bf(F.gelu(
            _k_steps(t[0], w1b[j]) + b1[j])) @ w2b[:, j].T)
    else:
        hid = _bf(F.gelu(_gemm_tiles(u, w1b) + b1))
        mlp = _second_gemm(hid, w2b)
    out = x.reshape(-1, c) + g * (mlp + b2)

    gms = _bf(g * dy.reshape(-1, c))
    w2t, w1t = w2b.T, w1b.T
    if cb.fused(c):
        du = _fused_tiles([u, gms], lambda t, j: _bf(
            _k_steps(t[1], w2t[j]) * _gelu_grad(
                _k_steps(t[0], w1b[j]) + b1[j])) @ w1t[:, j].T)
    else:
        dh = _bf(_gemm_tiles(gms, w2t) * _gelu_grad(
            _gemm_tiles(u, w1b) + b1))
        du = _gemm_tiles(dh, w1t)
    dxh = du * ls
    dyconv = inv * (dxh - dxh.mean(-1, keepdim=True)
                    - xhat * (dxh * xhat).mean(-1, keepdim=True))
    corr = dw_walk(dyconv.reshape(x.shape), dw, flip=True)
    return out.reshape(x.shape), dy + corr


def _scaled_jax_params(rng, c):
    """JAX-layout block parameters whose matmul weights scale with
    1/sqrt(fan-in) (0.05 at C = 96, tests/test_torch_cuda.py::block_params),
    so the bf16 rounding error keeps its size at every width."""
    p = _jax_params(rng, c)
    p[4] = (rng.normal(size=(c, 4 * c)) * 0.5 / c ** 0.5).astype(np.float32)
    p[6] = (rng.normal(size=(4 * c, c)) / (4 * c) ** 0.5).astype(np.float32)
    return p


@pytest.fixture
def one_thread():
    """The walk's products are small: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_block_case(c, images=(5, 7, 11)):
    """Images (default five 7 x 11) at width c and the JAX reference's
    output and input gradient for them (one jitted call per case)."""
    rng = np.random.default_rng(21)
    pj = _scaled_jax_params(rng, c)
    x = rng.normal(size=images + (c,)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    @jax.jit
    def fwd_vjp(z, d):
        out, vjp = jax.vjp(lambda v: convnext_block_reference(v, *pj), z)
        return out, vjp(d)[0]

    out, dx = fwd_vjp(jnp.asarray(x), jnp.asarray(dy))
    return x, dy, pj, np.asarray(out), np.asarray(dx)


# one width per form (fused at 96; two GEMMs at 384 and 768), each with
# fewer tokens than one 128-token tile (one image, 77 tokens) and with one
# past a tile multiple (five images, 385 = 3 * 128 + 1)
@pytest.mark.parametrize("images", [1, 5])
@pytest.mark.parametrize("c", [96, 384, 768])
def test_block_kernel_order_matches_plain_and_jax(c, images, one_thread):
    x, dy, pj, want, dx_jax = _jax_block_case(c)
    x, dy, want, dx_jax = (a[:images] for a in (x, dy, want, dx_jax))
    pt = _torch_params(pj)
    xt, dyt = torch.tensor(x), torch.tensor(dy)

    out, dx = block_kernel_order(xt, dyt, *pt)
    plain = cb.convnext_block_plain(xt, *pt)
    dx_plain = cb.convnext_block_dx_plain(xt, dyt, *pt)
    torch.testing.assert_close(out, plain, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-2, rtol=2e-2)
    for ref in (dx_plain.numpy(), dx_jax):
        err = np.abs(dx.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err
    # the rounding is what separates the walk from the float32 versions
    assert float((out - plain).abs().max()) > 1e-5


# the other supported widths (fused at 128 and 192, two GEMMs at 256, 512
# and 1024) against the float32 plain versions, 2 x 65 = 130 tokens (a
# tile and two rows past it)
@pytest.mark.parametrize("c", [128, 192, 256, 512, 1024])
def test_block_kernel_order_matches_plain_every_width(c, one_thread):
    rng = np.random.default_rng(c)
    pt = _torch_params(_scaled_jax_params(rng, c))
    xt = torch.tensor(rng.normal(size=(2, 5, 13, c)).astype(np.float32))
    dyt = torch.tensor(rng.normal(size=xt.shape).astype(np.float32))
    out, dx = block_kernel_order(xt, dyt, *pt)
    torch.testing.assert_close(out, cb.convnext_block_plain(xt, *pt),
                               atol=2e-2, rtol=2e-2)
    dx_plain = cb.convnext_block_dx_plain(xt, dyt, *pt)
    assert float((dx - dx_plain).abs().max() / dx_plain.abs().max()) <= 2e-2


# the depthwise tiles' ragged edges at the other test shapes: 2 x 5 x 13
# (tiles past the bottom and the right edge at every width) against the
# plain versions and JAX, and the VOC stage-0 size 119 x 119 at C = 96
@pytest.mark.parametrize("c,images", [(96, (2, 5, 13)), (384, (2, 5, 13)),
                                      (768, (2, 5, 13)),
                                      (96, (1, 119, 119))])
def test_block_kernel_order_ragged_tiles(c, images, one_thread):
    x, dy, pj, want, dx_jax = _jax_block_case(c, images)
    pt = _torch_params(pj)
    xt, dyt = torch.tensor(x), torch.tensor(dy)
    out, dx = block_kernel_order(xt, dyt, *pt)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-2, rtol=2e-2)
    dx_plain = cb.convnext_block_dx_plain(xt, dyt, *pt)
    for ref in (dx_plain.numpy(), dx_jax):
        err = np.abs(dx.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err


# the depthwise walk alone: every width's tile at the VOC stage sizes
# (119, 59, 29, 14: ragged against 8- and 4-pixel tiles), a map smaller
# than one tile, and the correlation with the flipped taps
@pytest.mark.parametrize("c,hw", [(96, 119), (192, 59), (384, 29),
                                  (768, 14), (1024, 3), (128, 5), (256, 7),
                                  (512, 9)])
def test_dw_walk_matches_conv(c, hw, one_thread):
    rng = np.random.default_rng(c + hw)
    x = torch.tensor(rng.normal(size=(1, hw, hw + 2, c)).astype(np.float32))
    dw = torch.tensor(rng.normal(size=(c, 1, 7, 7)).astype(np.float32))
    xc = x.permute(0, 3, 1, 2)
    for flip in (False, True):
        want = F.conv2d(xc, dw.flip(-1, -2) if flip else dw, padding=3,
                        groups=c).permute(0, 2, 3, 1)
        torch.testing.assert_close(dw_walk(x, dw, flip), want, atol=1e-5,
                                   rtol=1e-5)


def _cuda_source(name):
    path = os.path.join(os.path.dirname(cb.__file__), "..", "csrc", name)
    with open(path) as f:
        return f.read()


def test_dw_tiles_are_the_kernels():
    """DW_TILES and the engine's constants are the CUDA source's, and
    every pass at every width fits a ring of at least two stages (a stage
    holds a chunk's halo, its 49 taps and, where the pass reads dy, dy's
    box; y or the correlation tile beside the ring) into its block's budget, which two
    blocks an SM leave (228 KB of shared memory, 1 KB reserved a block)."""
    src = _cuda_source("convnext_block.cu")
    table = src[src.index("#define ROBSEG_DW_TILES"):]
    table = table[:table.index("\n\n")]
    tiles = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", table)}
    assert tiles == cb.DW_TILES
    for name, value in (("kDwChunk", cb.DW_CHUNK),
                        ("kDwMaxStages", cb.DW_MAX_STAGES),
                        ("kDwBlocksPerSm", cb.DW_BLOCKS_PER_SM),
                        ("kDwThreads", 32 * cb.DW_WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"constexpr int kDwSmemBudget = 113 \* 1024;", src)
    assert cb.DW_BLOCKS_PER_SM * (cb.DW_SMEM_BUDGET + 1024) <= 228 * 1024

    def align(v):
        return -(-v // 128) * 128

    taps = 49 * cb.DW_CHUNK * 4
    for c, (th, tw, _, _) in cb.DW_TILES.items():
        halo, box = (th + 6) * (tw + 6) * cb.DW_CHUNK, th * tw * cb.DW_CHUNK
        for io in (4, 2):
            for stage, tail in (
                    (align(halo * io) + taps, th * tw * c * 4),  # forward
                    (align(halo * io) + taps + align(box * io),
                     th * tw * c * 4),                           # backward
                    (align(halo * 4) + taps + align(box * io),
                     box * 4)):                                  # dwcorr
                stages = min(cb.DW_MAX_STAGES, (cb.DW_SMEM_BUDGET - 128 - tail)
                             // (stage + 8))
                assert stages >= 2, (c, io, stage, tail)


def test_mlp_tiles_are_the_kernels():
    """The MLP kernels' tiling constants are the CUDA source's, and every
    width's plan fits: the fused forward two token tiles and a ring of at
    least four slots, the backward a ring of three, each GEMM width a ring
    of two stages beside the staging boxes (227 KB a block)."""
    src = _cuda_source("convnext_mlp.cuh")
    line = re.search(r"#define ROBSEG_GEMM_BN\(X\)(.*)", src).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", line)) == cb.GEMM_BN
    for name, value in (("kTM", cb.TILE_M), ("kHC", cb.HIDDEN_CHUNK),
                        ("kBoxRows", cb.STORE_BOX[0]),
                        ("kFusedMaxC", cb.FUSED_MAX_C)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # the fused h product: K16-deep steps, C / K16 of them
    assert re.search(r"for \(int k = 0; k < C / 16; \+\+k\)", src)
    assert cb.STORE_BOX[1] * 2 == 128  # a box row: the 128-byte swizzle
    smem, slab = 232448, cb.TILE_M * 128
    for c in (96, 128, 192):
        kc = -(-c // 64)
        slot = max(kc * 64 * 128, c * 128)
        assert (smem - 1024 - 2 * kc * slab - 8 * 28) // slot >= 4, c
        assert (220 * 1024 - 2 * kc * slab - 2048) // slot >= 3, c
    for bn in cb.GEMM_BN:
        stage, staging = (128 + bn) * 128, 8 * 2 * 16 * 128
        assert (smem - 1024 - staging - 96) // stage >= 2, bn


def _store_cover(m, n, bn):
    """How often each element of an (m, n) bf16 output is written by the
    TMA store boxes the kernels issue: in each TILE_M x bn tile, each
    consumer warp's STORE_BOX[0] rows (warpgroup w's rows 64 w .. 64 w +
    63, warp v's 16 of them from 16 v) and each STORE_BOX[1]-column box
    of the tile's columns; TMA writes only what lies inside (m, n)."""
    rows, cols = cb.STORE_BOX
    cover = np.zeros((m, n), np.int32)
    for m0 in range(0, m, cb.TILE_M):
        for n0 in range(0, n, bn):
            for r in range(m0, m0 + cb.TILE_M, rows):
                for c0 in range(n0, n0 + bn, cols):
                    cover[r:r + rows, c0:c0 + cols] += 1
    return cover


# the fused forward (one tile holds every channel, KC slabs of 64) and the
# GEMMs (the hidden layer n x 4C and out n x C, BN from the plan) at the
# model's batch-16 stages, VOC's ragged batch-8 stages and every other
# width with a ragged token count
@pytest.mark.parametrize("n,c", [(16 * 128 * 128, 96), (8 * 119 * 119, 96),
                                 (16 * 64 * 64, 192), (8 * 59 * 59, 192),
                                 (16 * 32 * 32, 384), (8 * 29 * 29, 384),
                                 (16 * 16 * 16, 768), (8 * 14 * 14, 768),
                                 (130, 128), (385, 256), (99, 512),
                                 (2 * 7 * 9, 1024)])
def test_store_boxes_cover_each_output_once(n, c):
    if cb.fused(c):
        outs = [(n, c, -(-c // 64) * 64)]
    else:  # the bf16 hidden layer, then the block's bf16 out
        outs = [(n, 4 * c, cb.TILE_N), (n, c, cb.gemm_bn(n, c, H100_SMS))]
    for m, w, bn in outs:
        assert bool((_store_cover(m, w, bn) == 1).all()), (m, w, bn)


def test_second_gemm_walk():
    """The second GEMM's tiles (n x C, BN from the plan) cover the output
    once at every GEMM width; at the batch-16 stages the plan takes 192 at
    C = 384 and 768 (one wave at 16^2: 128 tiles, where 128-wide tiles
    left 60 of 132 SMs a second tile)."""
    for c in (256, 384, 512, 768, 1024):
        for n in (16 * (512 // 4 // 2 ** (i + 1)) ** 2 for i in range(4)):
            bn = cb.gemm_bn(n, c, H100_SMS)
            assert c % bn == 0
            cover = np.zeros((-(-n // cb.TILE_M), c // 64), np.int32)
            for t in range(cover.shape[0] * (c // bn)):
                m0, n0 = t // (c // bn), (t % (c // bn)) * bn // 64
                cover[m0, n0:n0 + bn // 64] += 1
            assert bool((cover == 1).all()), (n, c, bn)
    assert cb.gemm_bn(16 * 32 * 32, 384, H100_SMS) == 192
    assert cb.gemm_bn(16 * 16 * 16, 768, H100_SMS) == 192
    assert -(-(16 * 16 * 16 // 128) * (768 // 192) // H100_SMS) == 1
    assert -(-(16 * 16 * 16 // 128) * (768 // 128) // H100_SMS) == 2


@pytest.mark.parametrize("c", [96, 128, 192, 384])
def test_k_tail_skip_sums_the_zero_filled_walk(c):
    """Leaving out the K16 steps that lie wholly in the zero fill (at C =
    96 two of the second slab's four) gives the zero-filled walk's sums
    exactly: each skipped step adds products of zeros."""
    rng = np.random.default_rng(c)
    a = torch.tensor(rng.normal(size=(128, c)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(64, c)).astype(np.float32))
    assert cb.fused_h_steps(c) == c // 16
    assert torch.equal(_k_steps(a, b), _k_steps(a, b, skip=False))
    torch.testing.assert_close(_k_steps(a, b), a @ b.T, atol=1e-4,
                               rtol=1e-5)


def test_block_mlp_form_by_width():
    # the fused kernel holds a 64 x C f32 accumulator in C / 2 registers a
    # thread beside h, da and the A fragments; 256 and wider take the two
    # GEMMs (csrc/convnext_block.cu)
    assert [c for c in (96, 128, 192, 256, 384, 512, 768, 1024)
            if cb.fused(c)] == [96, 128, 192]


@pytest.mark.parametrize("name", ["convnext_block_fwd", "convnext_block_dx",
                                  "apgd_linf_step", "confusion_matrix",
                                  "fpn_concat_conv_fwd", "fpn_concat_conv_dx",
                                  "convnext_mlp_fwd", "convnext_mlp_dx",
                                  "convnext_block_fwd_bf16",
                                  "convnext_block_dx_bf16",
                                  "fpn_concat_conv_fwd_bf16",
                                  "fpn_concat_conv_dx_bf16"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A CUDA wrapper raises on a CPU tensor (before any build) and counts
    no launch; only the dispatchers pick the plain version."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1, 5, 6, 96)).astype(np.float32))
    p = _torch_params(_jax_params(rng, 96))
    img = torch.rand(2, 3, 4, 4)
    lab = torch.zeros(2, 4, 4, dtype=torch.int64)
    fw, fv = torch.zeros(1, 3, 3, 96, 96), torch.ones(96)
    xb, pb = x.bfloat16(), [t.bfloat16() for t in p]
    calls = {
        "convnext_block_fwd": lambda: kernels.convnext_block_fwd_cuda(x, *p),
        "convnext_block_dx": lambda: kernels.convnext_block_dx_cuda(x, x, *p),
        "apgd_linf_step": lambda: kernels.apgd_linf_step_cuda(
            img, img, img, img, torch.ones(2), 0.03, 1.0),
        "confusion_matrix": lambda: kernels.confusion_matrix_cuda(
            lab, lab, num_classes=21),
        "fpn_concat_conv_fwd": lambda: kernels.fpn_concat_conv_fwd_cuda(
            [x], fw, fv, fv),
        "fpn_concat_conv_dx": lambda: kernels.fpn_concat_conv_dx_cuda(
            x, x, fw, fv),
        "convnext_mlp_fwd": lambda: kernels.convnext_mlp_fwd_cuda(x, *p[2:]),
        "convnext_mlp_dx": lambda: kernels.convnext_mlp_dx_cuda(
            x, x, *p[2:7], p[8]),
        "convnext_block_fwd_bf16": lambda: kernels.convnext_block_fwd_bf16_cuda(
            xb, *pb),
        "convnext_block_dx_bf16": lambda: kernels.convnext_block_dx_bf16_cuda(
            xb, xb, *pb),
        "fpn_concat_conv_fwd_bf16":
            lambda: kernels.fpn_concat_conv_fwd_bf16_cuda([xb], fw, fv, fv),
        "fpn_concat_conv_dx_bf16": lambda: kernels.fpn_concat_conv_dx_bf16_cuda(
            xb, xb, fw, fv),
    }
    before = kernels.launch_counts()[name]
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()
    assert kernels.launch_counts()[name] == before


@pytest.mark.parametrize("i", [0, 3])
def test_apgd_step_plain_matches_jax_inline(i):
    rng = np.random.default_rng(i)
    shape = (3, 3, 17, 13)  # NCHW; the step is elementwise
    x = rng.random(shape).astype(np.float32)
    x_adv = np.clip(x + rng.uniform(-.03, .03, shape), 0, 1).astype(
        np.float32)
    x_old = np.clip(x + rng.uniform(-.03, .03, shape), 0, 1).astype(
        np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    grad[0, 0, 0, :4] = 0.0
    step = rng.uniform(0.01, 0.05, (3, 1, 1, 1)).astype(np.float32)
    eps = np.float32(8 / 255)

    # robseg_tpu/attacks/apgd.py:367-375, verbatim
    a = jnp.where(i > 0, 0.75, 1.0).astype(jnp.float32)
    grad2 = x_adv - x_old
    z = jnp.asarray(x_adv) + jnp.asarray(step) * jnp.sign(grad)
    z = j_project_linf(z, x, eps)
    want = j_project_linf(x_adv + (z - x_adv) * a + grad2 * (1.0 - a), x,
                          eps)

    got = kernels.apgd_linf_step_plain(
        *map(torch.tensor, (x, x_adv, x_old, grad, step)), float(eps),
        0.75 if i > 0 else 1.0)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_confusion_plain_matches_jax():
    rng = np.random.default_rng(5)
    k = 21
    t = rng.integers(0, k, (3, 29, 31))
    p = rng.integers(-1, k + 3, t.shape)  # out-of-range preds count nowhere
    ign = rng.random(t.shape) < 0.05
    t[ign] = -1
    p[ign[::-1]] = -1
    pj, tj = jnp.asarray(p.astype(np.int32)), jnp.asarray(t.astype(np.int32))
    want = np.asarray(jm.confusion_matrix(pj, tj, num_classes=k))
    got = kernels.confusion_matrix_plain(torch.tensor(p), torch.tensor(t),
                                         num_classes=k)
    assert np.array_equal(got.numpy(), want)
    per = kernels.confusion_matrix_plain(torch.tensor(p), torch.tensor(t),
                                         num_classes=k, per_image=True)
    for b in range(3):
        want_b = np.asarray(jm._hist_matmul(pj[b], tj[b], tj[b] != -1, k))
        assert np.array_equal(per[b].numpy(), want_b)
