"""The plain versions of the port's kernels against the pure-JAX functions.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances: the block
forward atol 5e-6 / rtol 1e-5 and its input gradient atol 1e-5 / rtol 1e-4
(the bounds of tests/test_kernels.py for float32 dots); the APGD step and
the confusion histogram exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.convnext_block import convnext_block_reference
from robseg_tpu.ops import metrics as jm
from robseg_tpu.ops.projections import project_linf as j_project_linf
from robseg_torch import kernels
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


@pytest.mark.parametrize("name", ["convnext_block_fwd", "convnext_block_dx",
                                  "apgd_linf_step", "confusion_matrix",
                                  "fpn_concat_conv_fwd", "fpn_concat_conv_dx",
                                  "convnext_mlp_fwd", "convnext_mlp_dx"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """A CUDA wrapper raises on a CPU tensor (before any build) and counts
    no launch; only the dispatchers pick the plain version."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1, 5, 6, 96)).astype(np.float32))
    p = _torch_params(_jax_params(rng, 96))
    img = torch.rand(2, 3, 4, 4)
    lab = torch.zeros(2, 4, 4, dtype=torch.int64)
    fw, fv = torch.zeros(1, 3, 3, 96, 96), torch.ones(96)
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
