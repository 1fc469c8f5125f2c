"""The plain MLP tail of the port (robseg_torch/kernels/convnext_mlp.py)
against the pure-JAX functions, on the CPU, in all four modes.

Float32 modes (``residual``, ``recompute``) against
``convnext_mlp_reference`` and its ``jax.grad``: forward atol 2e-5,
input gradient atol 5e-4 / rtol 1e-3 (tests/test_kernels.py:81-104,
142-145). The bf16 modes against the bf16 oracle of
tests/test_kernels.py:183-195 (matmul operands rounded to bf16, f32
accumulation) and, for the gradient, the same formula after the TPU
kernel's ``_bwd_kernel`` with its ``_dot(.., mxu_bf16=True)``: atol 2e-3 /
rtol 1e-2, the bound of tests/test_kernels.py:214-215 (two float32 sums
that differ in the last bit can round one bf16 operand apart); and
against the float32 gradient at atol = rtol = 5e-2 (:235-236). The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.convnext_mlp import _dot, convnext_mlp_reference
from robseg_torch.kernels.convnext_mlp import (MODES, convnext_mlp,
                                               convnext_mlp_fwd_plain)

C = 96           # not a multiple of 128
SHAPE = (2, 19, 13, C)  # H = 19: not a multiple of any tile


def _jax_params(rng, c=C):
    """JAX-layout parameters, the scales of tests/test_kernels.py:56-67."""
    return dict(
        ln_scale=(rng.random(c) + 0.5).astype(np.float32),
        ln_bias=(rng.normal(size=c) * 0.1).astype(np.float32),
        w1=(rng.normal(size=(c, 4 * c)) * 0.05).astype(np.float32),
        b1=(rng.normal(size=4 * c) * 0.1).astype(np.float32),
        w2=(rng.normal(size=(4 * c, c)) * 0.05).astype(np.float32),
        b2=(rng.normal(size=c) * 0.1).astype(np.float32),
        gamma=rng.random(c).astype(np.float32))


def _torch_params(p):
    """JAX layout -> the state_dict layout the port takes."""
    return [torch.tensor(a) for a in (
        p["ln_scale"], p["ln_bias"], np.ascontiguousarray(p["w1"].T),
        p["b1"], np.ascontiguousarray(p["w2"].T), p["b2"], p["gamma"])]


def _ln(x, p):
    mean = x.mean(-1, keepdims=True)
    d = x - mean
    inv = jax.lax.rsqrt((d * d).mean(-1, keepdims=True) + 1e-6)
    return d * inv, inv, d * inv * p["ln_scale"] + p["ln_bias"]


def _fwd_oracle(x, p, bf16):
    """tests/test_kernels.py:183-195 (bf16=True), or the float32 tail."""
    _, _, u = _ln(x, p)
    h = _dot(u, p["w1"], bf16) + p["b1"]
    a = jax.nn.gelu(h, approximate=False)
    return p["gamma"] * (_dot(a, p["w2"], bf16) + p["b2"])


def _dx_oracle(x, gout, p, bf16):
    """Input gradient in the order of robseg_tpu/kernels/convnext_mlp.py
    ``_bwd_kernel``, with the exact erf."""
    xhat, inv, u = _ln(x, p)
    h = _dot(u, p["w1"], bf16) + p["b1"]
    da = _dot(gout * p["gamma"], p["w2"].T, bf16)
    cdf = 0.5 * (1.0 + jax.scipy.special.erf(h * 0.7071067811865476))
    pdf = 0.3989422804014327 * jnp.exp(-0.5 * h * h)
    dxhat = _dot(da * (cdf + h * pdf), p["w1"].T, bf16) * p["ln_scale"]
    s1 = dxhat.mean(-1, keepdims=True)
    s2 = (dxhat * xhat).mean(-1, keepdims=True)
    return inv * (dxhat - s1 - xhat * s2)


def _port(x, p, mode):
    """The port's forward and the input gradient of sum(out**2)."""
    xt = torch.tensor(x, requires_grad=True)
    out = convnext_mlp(xt, *_torch_params(p), mode=mode)
    (out ** 2).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("mode", ["residual", "recompute"])
def test_f32_modes_match_jax_reference(mode):
    rng = np.random.default_rng(0)
    p = _jax_params(rng)
    x = rng.normal(size=SHAPE).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = np.asarray(convnext_mlp_reference(jnp.asarray(x), **jp))
    gw = np.asarray(jax.grad(lambda z: (convnext_mlp_reference(z, **jp)
                                        ** 2).sum())(jnp.asarray(x)))
    out, g = _port(x, p, mode)
    np.testing.assert_allclose(out, want, atol=2e-5)
    np.testing.assert_allclose(g, gw, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", ["residual_bf16", "recompute_bf16"])
def test_bf16_modes_match_bf16_oracle(mode):
    rng = np.random.default_rng(7)
    p = _jax_params(rng)
    x = rng.normal(size=SHAPE).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xj = jnp.asarray(x)
    want = np.asarray(_fwd_oracle(xj, jp, True))
    out, g = _port(x, p, mode)
    np.testing.assert_allclose(out, want, atol=2e-3, rtol=1e-2)
    gw = np.asarray(_dx_oracle(xj, 2 * jnp.asarray(out), jp, True))
    np.testing.assert_allclose(g, gw, atol=2e-3, rtol=1e-2)
    g32 = np.asarray(jax.grad(lambda z: (convnext_mlp_reference(z, **jp)
                                         ** 2).sum())(xj))
    np.testing.assert_allclose(g, g32, atol=5e-2, rtol=5e-2)


def test_dx_oracle_is_the_gradient():
    """The float32 form of the backward oracle equals jax.grad, so the
    bf16 test above checks the backward of the same function."""
    rng = np.random.default_rng(3)
    p = {k: jnp.asarray(v) for k, v in _jax_params(rng).items()}
    x = jnp.asarray(rng.normal(size=(1, 5, 7, C)).astype(np.float32))
    gout = jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
    _, vjp = jax.vjp(lambda z: _fwd_oracle(z, p, False), x)
    np.testing.assert_allclose(np.asarray(_dx_oracle(x, gout, p, False)),
                               np.asarray(vjp(gout)[0]), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_saved_hidden_and_no_parameter_gradients(mode):
    rng = np.random.default_rng(4)
    p = _jax_params(rng)
    x = rng.normal(size=(1, 6, 5, C)).astype(np.float32)
    save_h, bf16 = MODES[mode]
    params = [t.requires_grad_(True) for t in _torch_params(p)]
    xt = torch.tensor(x, requires_grad=True)
    # a weight that requires grad makes the backward raise, none is filled
    with pytest.raises(RuntimeError, match="input gradients only"):
        convnext_mlp(xt, *params, mode=mode).sum().backward()
    assert all(t.grad is None for t in params)
    xt = torch.tensor(x, requires_grad=True)
    convnext_mlp(xt, *[t.detach() for t in params],
                 mode=mode).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    _, h = convnext_mlp_fwd_plain(torch.tensor(x), *params, save_h=save_h,
                                  bf16_operands=bf16)
    if save_h:
        _, _, u = _ln(jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in p.items()})
        want = _dot(u, jnp.asarray(p["w1"]), bf16) + p["b1"]
        np.testing.assert_allclose(h.detach().numpy(),
                                   np.asarray(want).reshape(-1, 4 * C),
                                   atol=2e-3 if bf16 else 1e-5,
                                   rtol=1e-2 if bf16 else 1e-5)
    else:
        assert h is None


# ---------------------------------------------------------------------
# The kernels' order, walked on the CPU: csrc/convnext_mlp_f32.cu (3xTF32)
# and the bf16 forms of csrc/convnext_mlp.cuh, against the plain versions
# and the JAX reference. The walk cannot show the tensor core's own
# accumulation inside a K-step; chip_smoke.py holds the kernels against
# the plain versions on the card for that.

import functools  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from robseg_torch.kernels import convnext_block as cb  # noqa: E402
from robseg_torch.kernels import convnext_mlp as cm  # noqa: E402


def _tf32_hi(a):
    """cvt.rna.tf32.f32: round to nearest at 10 mantissa bits, ties away
    from zero (float bits are sign and magnitude, so adding half of the
    dropped range to the magnitude rounds it)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(a):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _tf32_hi(a)
    return hi, _tf32_read(a - hi)


def _tf32_gemm(a, w):
    """a (m, k) . w (n, k)^T as mlp_tf32_kernel walks it: 128-row token
    tiles (rows past m are TMA zero fill), output tiles of tf32_tile_n(n)
    columns, 32-deep K-steps, each step's three passes a_lo.w_hi +
    a_hi.w_lo + a_hi.w_hi (a split on chip, w split by the packing) summed
    apart and added to the tile's float32 sum in K order."""
    m, k = a.shape
    n, bn = w.shape[0], cm.tf32_tile_n(w.shape[0])
    a = F.pad(a, (0, 0, 0, -m % cm.TF32_TILE_M))
    (ah, al), (wh, wl) = _split(a), _split(w)
    out = torch.zeros(a.shape[0], n)
    for n0 in range(0, n, bn):
        cols = slice(n0, n0 + bn)
        for k0 in range(0, k, cm.TF32_K_STEP):
            ks = slice(k0, k0 + cm.TF32_K_STEP)
            t = sum(x[:, ks].double() @ y[cols, ks].double().T
                    for x, y in ((al, wh), (ah, wl), (ah, wh)))
            out[:, cols] += t.float()
    return out[:m]


def _k_steps(a, b):
    """a . b^T over K in the bf16 kernels' 64-deep steps (the C = 96 tail
    zero-filled), the steps' products summed in order."""
    k, steps = cb.HIDDEN_CHUNK, -(-a.shape[1] // cb.HIDDEN_CHUNK)
    a, b = (F.pad(t, (0, steps * k - t.shape[1])).reshape(
        t.shape[0], steps, k) for t in (a, b))
    out = torch.zeros(a.shape[0], b.shape[0])
    for s in range(steps):
        out += a[:, s] @ b[:, s].T
    return out


def _by_chunk(a, w):
    """mlp_fused_kernel's second product: a (m, 4C) . w (C, 4C)^T one
    64-wide hidden chunk at a time into an f32 accumulator."""
    out = torch.zeros(a.shape[0], w.shape[0])
    for j in range(0, a.shape[1], cb.HIDDEN_CHUNK):
        js = slice(j, j + cb.HIDDEN_CHUNK)
        out += a[:, js] @ w[:, js].T
    return out


def _bf(t):
    return t.to(torch.bfloat16).float()


def _gelu_grad(v):
    return 0.5 * (1 + torch.erf(v * 0.7071067811865476)) + v * torch.exp(
        -0.5 * v * v) * 0.3989422804014327


def tail_kernel_order(y, dy, ls, lb, w1, b1, w2, b2, g, bf16):
    """The tail's forward, saved h and input gradient (h read) as the
    kernels compute them: a LayerNorm pass, then float32 operands through
    two 3xTF32 GEMMs, or bf16 operands rounded where the TPU kernel rounds
    them (u, W1, gelu(h), W2; gamma dy, dh) through the block's fused
    kernel (C <= 192: hidden chunks into one accumulator) or its two
    GEMMs."""
    shape, c = y.shape, y.shape[-1]
    y, dy = y.reshape(-1, c), dy.reshape(-1, c)
    xhat, inv, u = cm._layer_norm(y, ls, lb)
    if not bf16:
        h = _tf32_gemm(u, w1) + b1
        out = g * (_tf32_gemm(F.gelu(h), w2) + b2)
        dh = _tf32_gemm(g * dy, w2.T.contiguous()) * _gelu_grad(h)
        du = _tf32_gemm(dh, w1.T.contiguous())
    else:
        w1b, w2b = _bf(w1), _bf(w2)
        h = _k_steps(_bf(u), w1b) + b1
        a = _bf(F.gelu(h))
        dh = _bf(_k_steps(_bf(g * dy), w2b.T) * _gelu_grad(h))
        if cb.fused(c):
            out, du = _by_chunk(a, w2b), _by_chunk(dh, w1b.T)
        else:
            out, du = _k_steps(a, w2b), _k_steps(dh, w1b.T)
        out = g * (out + b2)
    dxh = du * ls
    dx = inv * (dxh - dxh.mean(-1, keepdim=True)
                - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return out.reshape(shape), h, dx.reshape(shape)


@functools.lru_cache(maxsize=None)
def _jax_tail_case(c):
    """One image of 11 x 13 tokens (a 128-token tile and 15 rows), and
    the JAX reference's float32 output and input gradient, and the bf16
    oracles', for them."""
    rng = np.random.default_rng(c)
    p = _jax_params(rng, c)
    x = rng.normal(size=(1, 11, 13, c)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xj, dj = jnp.asarray(x), jnp.asarray(dy)
    out, vjp = jax.vjp(lambda z: convnext_mlp_reference(z, **jp), xj)
    return (x, dy, p, np.asarray(out), np.asarray(vjp(dj)[0]),
            np.asarray(_fwd_oracle(xj, jp, True)),
            np.asarray(_dx_oracle(xj, dj, jp, True)))


def _close_bf16(got, want):
    """The bf16 kernels against a version that rounds at the same places:
    max error <= 2e-3 of the largest entry (chip_smoke.py's bound)."""
    return float((got - want).abs().max() / want.abs().max()) <= 2e-3


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [96, 384])
def test_tail_kernel_order_matches_plain_and_jax(c, bf16):
    x, dy, p, want, dx_jax, want_bf, dx_bf = _jax_tail_case(c)
    pt = _torch_params(p)
    ls, lb, w1, b1, w2, b2, g = pt
    xt, dyt = torch.tensor(x), torch.tensor(dy)
    out, h, dx = tail_kernel_order(xt, dyt, *pt, bf16=bf16)
    plain, h_plain = cm.convnext_mlp_fwd_plain(xt, *pt, save_h=True,
                                               bf16_operands=bf16)
    dx_plain = cm.convnext_mlp_dx_plain(xt, dyt, ls, lb, w1, b1, w2, g,
                                        h=h_plain, bf16_operands=bf16)
    if bf16:
        assert _close_bf16(out, plain) and _close_bf16(dx, dx_plain)
        assert _close_bf16(h, h_plain)
        np.testing.assert_allclose(out.numpy(), want_bf, atol=2e-3,
                                   rtol=1e-2)
        np.testing.assert_allclose(dx.numpy(), dx_bf, atol=2e-3, rtol=1e-2)
        np.testing.assert_allclose(dx.numpy(), dx_jax, atol=5e-2, rtol=5e-2)
    else:
        for ref in (plain.numpy(), want):
            np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
        for ref in (dx_plain.numpy(), dx_jax):
            np.testing.assert_allclose(dx.numpy(), ref, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(h, h_plain, atol=2e-5, rtol=0)


# the other widths against the plain versions, 2 x 65 = 130 tokens (a
# tile and two rows past it)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [128, 192, 256])
def test_tail_kernel_order_matches_plain_every_width(c, bf16):
    rng = np.random.default_rng(c + 1)
    pt = _torch_params(_jax_params(rng, c))
    ls, lb, w1, b1, w2, b2, g = pt
    xt = torch.tensor(rng.normal(size=(2, 5, 13, c)).astype(np.float32))
    dyt = torch.tensor(rng.normal(size=xt.shape).astype(np.float32))
    out, _, dx = tail_kernel_order(xt, dyt, *pt, bf16=bf16)
    plain, h_plain = cm.convnext_mlp_fwd_plain(xt, *pt, save_h=True,
                                               bf16_operands=bf16)
    dx_plain = cm.convnext_mlp_dx_plain(xt, dyt, ls, lb, w1, b1, w2, g,
                                        h=h_plain, bf16_operands=bf16)
    if bf16:
        assert _close_bf16(out, plain) and _close_bf16(dx, dx_plain)
    else:
        torch.testing.assert_close(out, plain, atol=2e-5, rtol=0)
        torch.testing.assert_close(dx, dx_plain, atol=5e-4, rtol=1e-3)


def test_tf32_split_rounds_to_nearest_and_keeps_the_remainder():
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.normal(size=4096).astype(np.float32))
    a[:2] = torch.tensor([1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -11)])  # ties
    hi = _tf32_hi(a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    ulp = 2.0 ** (torch.floor(torch.log2(a.abs())) - 10)
    assert bool(((a - hi).abs() <= ulp / 2).all())
    assert hi[0] == 1 + 2.0 ** -10 and hi[1] == -(1 + 2 * 2.0 ** -10)
    # hi + lo as the tensor core reads them keeps ~21 significant bits
    _, lo = _split(a)
    assert bool(((hi + lo - a).abs() <= a.abs() * 2.0 ** -20).all())


def test_tf32_output_tiles_cover_every_width():
    # 128-wide tiles for the 4C-wide products, 96 or 128 for the C-wide
    # ones; each width a whole number of tiles (no store mask)
    for c in (96, 128, 192, 256, 384):
        for n in (c, 4 * c):
            assert n % cm.tf32_tile_n(n) == 0
    assert [cm.tf32_tile_n(c) for c in (96, 128, 192, 256, 384)] == [
        96, 128, 96, 128, 128]
