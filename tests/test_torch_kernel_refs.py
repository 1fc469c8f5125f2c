"""The plain versions of the port's kernels against the pure-JAX functions.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances: the block
forward atol 5e-6 / rtol 1e-5 and its input gradient atol 1e-5 / rtol 1e-4
(the bounds of tests/test_kernels.py for float32 dots); the APGD step and
the confusion histogram exact.

What the block kernels compute is held here too: the block written in the
kernels' order (csrc/convnext_block.cu: 128-token tiles zero-filled past
the last token, 64-wide hidden chunks in the fused form at C <= 192, 128 x
128 tiles with 64-deep K-steps through a bf16 hidden layer above it,
K walked in 64-channel slabs) and rounded to bf16 exactly where the
kernels round, against the float32 plain versions and the JAX reference
at the bf16 bounds of the card tests (forward atol = rtol = 2e-2, input
gradient max error <= 2e-2 of its largest entry).
"""

import functools

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
    x = torch.tensor(rng.normal(size=(1, 9, 11, 96)).astype(np.float32),
                     requires_grad=True)
    convnext_block(x, *params).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is None for p in params)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _gelu_grad(v):
    return 0.5 * (1 + torch.erf(v * 0.7071067811865476)) + v * torch.exp(
        -0.5 * v * v) * 0.3989422804014327


def _k_steps(a, b):
    """a . b^T over K in the kernels' 64-deep steps (one shared-memory slab
    of the token tile and of the weight panel each, the C = 96 tail
    zero-filled), the steps' products summed."""
    k = cb.HIDDEN_CHUNK
    steps = -(-a.shape[1] // k)
    a, b = (F.pad(t, (0, steps * k - t.shape[1])).reshape(
        t.shape[0], steps, k) for t in (a, b))
    return torch.einsum("msk,nsk->smn", a, b).sum(0)


def _gemm_tiles(a, b):
    """a (m, k) . b (n, k)^T over TILE_M x TILE_N output tiles, as
    mlp_gemm_kernel walks them (rows past m are TMA zero fill)."""
    m, n = a.shape[0], b.shape[0]
    a = F.pad(a, (0, 0, 0, -m % cb.TILE_M))
    out = torch.zeros(a.shape[0], n)
    for m0 in range(0, a.shape[0], cb.TILE_M):
        for n0 in range(0, n, cb.TILE_N):
            out[m0:m0 + cb.TILE_M, n0:n0 + cb.TILE_N] = _k_steps(
                a[m0:m0 + cb.TILE_M], b[n0:n0 + cb.TILE_N])
    return out[:m]


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


def block_kernel_order(x, dy, dw, dwb, ls, lb, w1, b1, w2, b2, g):
    """The block's forward and input gradient as csrc/convnext_block.cu
    computes them, rounding to bf16 where the kernels round: u, W1, W2,
    gelu(h) (forward), gms = gamma * dy and dh (backward)."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw, dwb, padding=3, groups=c)
    y = y.permute(0, 2, 3, 1).reshape(-1, c)
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
        mlp = _gemm_tiles(hid, w2b)
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
    corr = F.conv2d(dyconv.reshape(x.shape).permute(0, 3, 1, 2),
                    dw.flip(-1, -2), padding=3, groups=c)
    return out.reshape(x.shape), dy + corr.permute(0, 2, 3, 1)


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
def _jax_block_case(c):
    """Five 7 x 11 images at width c and the JAX reference's output and
    input gradient for them (one jitted call per width)."""
    rng = np.random.default_rng(21)
    pj = _scaled_jax_params(rng, c)
    x = rng.normal(size=(5, 7, 11, c)).astype(np.float32)
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
