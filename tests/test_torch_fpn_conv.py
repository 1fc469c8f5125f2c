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
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.fpn_conv import fpn_concat_conv_reference
from robseg_torch.kernels.fpn_conv import (fpn_concat_conv,
                                           fpn_concat_conv_dx_plain,
                                           fpn_concat_conv_plain)


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
