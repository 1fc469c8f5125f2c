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
    convnext_mlp(xt, *params, mode=mode).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    assert all(t.grad is None for t in params)
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
