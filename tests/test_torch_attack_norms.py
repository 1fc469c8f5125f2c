"""The rest of the attack engine against the JAX package: the L2 and L1
projections, the other attack losses, L2 and L1 APGD, targeted restarts,
the filter attack, ``run_attack_over_loader`` and ``iou_acc_summary``.

The attacks run on the tiny conv model of tests/test_torch_apgd.py with
the same weights in both frameworks, in float64 (JAX with x64 on, reset in
``finally``), with that file's trajectory tolerance: atol 1e-8 on the
points and losses, 1e-7 on the accuracies.

One exception, measured and explained: the L1 projection. The JAX
function computes it in float32 whatever its input (``.astype(float32)``,
``robseg_tpu/ops/projections.py:61-62``), and its float32 sums and prefix
sums (XLA's blocked ``reduce_window``) round otherwise than torch's, by
up to ~1e-6 of eps. So the projection is held to atol 1e-5 x max(eps, 1)
against JAX's, and the L1 loop twice: with the projection's values taken
from JAX's function (atol 1e-8: the port's loop, step and sparsity
controller are exact), and with its own projection over its first 4
iterations (atol 1e-6). Further on, a coordinate that the float32
projection puts at exactly 0 in one package and at 1e-9 in the other
changes the sparsity count that the controller reads, and the two
trajectories part.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.attacks import apgd as japgd
from robseg_tpu.attacks.filters import pgd_filters as j_filters
from robseg_tpu.attacks.sea import run_attack_over_loader as j_loader
from robseg_tpu.ops import losses as jl
from robseg_tpu.ops import metrics as jm
from robseg_tpu.ops import projections as jp
from robseg_torch.attacks import apgd as tapgd
from robseg_torch.attacks import (apgd_restarts, pgd_filters,
                                  run_attack_over_loader)
from robseg_torch.ops import losses as tl
from robseg_torch.ops import iou_acc_summary, project_l1_ball_box, project_l2
from test_torch_apgd import B, C, _data, _models, _nhwc


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------- projections

@pytest.mark.parametrize("shape,eps,dtype", [
    ((3, 3, 10, 12), 2.0, np.float32), ((2, 3, 64, 64), 30.0, np.float32),
    ((4, 3, 5, 7), 0.5, np.float32), ((3, 3, 10, 12), 2.0, np.float64)])
def test_l1_projection_matches_jax(shape, eps, dtype):
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(dtype)
    y = (rng.normal(size=shape) * 0.2).astype(dtype)
    y[0, 0, :2] += 1.5  # box violations: x + y > 1
    y[-1, 1, :2] -= 1.5  # and < 0
    with x64():
        want = np.asarray(jp.project_l1_ball_box(_nhwc(x), _nhwc(y), eps))
    got = project_l1_ball_box(_t(x), _t(y), eps)
    assert got.dtype == _t(x).dtype
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0,
                               atol=1e-5 * max(eps, 1.0))
    z = x + y + got.numpy()
    assert z.min() >= -1e-6 and z.max() <= 1 + 1e-6
    l1 = np.abs(y + got.numpy()).reshape(shape[0], -1).sum(1)
    assert np.all(l1 <= eps * (1 + 1e-5))


def test_l1_projection_inside_ball_only_repairs_box():
    rng = np.random.default_rng(1)
    x = rng.random((2, 3, 6, 6)).astype(np.float32)
    y = (rng.normal(size=x.shape) * 1e-3).astype(np.float32)
    y[0, 0, 0, 0] = 1.2 - x[0, 0, 0, 0]  # one coordinate out of the box
    want = np.asarray(jp.project_l1_ball_box(_nhwc(x), _nhwc(y), 100.0))
    got = project_l1_ball_box(_t(x), _t(y), 100.0).numpy()
    np.testing.assert_allclose(got, _nchw(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose((x + y + got)[0, 0, 0, 0], 1.0, atol=1e-6)
    assert np.abs(got.reshape(-1)[1:]).max() == 0.0


@pytest.mark.parametrize("eps", [0.3, 5.0])
def test_l2_projection_matches_jax(eps):
    rng = np.random.default_rng(2)
    x = rng.random((3, 3, 8, 9))
    xa = x + rng.normal(size=x.shape) * 0.5  # leaves the box too
    with x64():
        want = np.asarray(jp.project_l2(_nhwc(xa), _nhwc(x), eps))
    got = project_l2(_t(xa), _t(x), eps).numpy()
    np.testing.assert_allclose(got, _nchw(want), rtol=0, atol=1e-12)
    assert got.min() >= 0 and got.max() <= 1


# --------------------------------------------------------------------- losses

def _logits(rng, k=6):
    lg = rng.normal(size=(2, 5, 7, k)).astype(np.float32) * 3
    y = rng.integers(0, k, (2, 5, 7))
    y[0, :2, :3] = -1
    yt = rng.integers(0, k, (2, 5, 7))
    return lg, y, yt


def test_new_losses_match_jax(rng):
    lg, y, yt = _logits(rng)
    w = (rng.random(lg.shape[-1]) + 0.5).astype(np.float32)
    jlg, jy, jyt = jnp.asarray(lg), jnp.asarray(y), jnp.asarray(yt)
    tlg, ty, tyt = _t(_nchw(lg)), _t(y), _t(yt)
    pairs = [
        (jl.margin_loss(jlg, jy), tl.margin_loss(tlg, ty)),
        (jl.dlr_loss(jlg, jy), tl.dlr_loss(tlg, ty)),
        (jl.dlr_loss_targeted(jlg, jy, jyt),
         tl.dlr_loss_targeted(tlg, ty, tyt)),
        (jl.targeted_cross_entropy(jlg, jyt, jnp.asarray(w)),
         tl.targeted_cross_entropy(tlg, tyt, _t(w))),
        (jl.js_div_pixelwise(jlg, jy), tl.js_div_pixelwise(tlg, ty)),
        (jl.ATTACK_CRITERIA["ce-targeted"](jlg, jyt, jnp.asarray(w)),
         tl.make_attack_criterion("ce-targeted")(tlg, tyt, _t(w)))]
    for want, got in pairs:
        assert got.shape == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert set(tl.ATTACK_CRITERIA) == set(jl.ATTACK_CRITERIA)
    with pytest.raises(ValueError, match="Unknown attack criterion"):
        tl.make_attack_criterion("cw")


def test_iou_acc_summary_matches_jax(rng):
    k = 7
    y = rng.integers(0, k, (3, 11, 13))
    y[1, :4] = -1
    pred = np.where(rng.random(y.shape) < 0.6, y, rng.integers(0, k, y.shape))
    want = jm.iou_acc_summary(jnp.asarray(pred), jnp.asarray(y),
                              num_classes=k)
    got = iou_acc_summary(_t(pred), _t(y), num_classes=k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ----------------------------------------------------------------- L2 and L1

def _run_both(norm, eps, n_iter, loss, seed=1, **extra):
    rng = np.random.default_rng(seed)
    jfn, tfn = _models(rng)
    x, y, _ = _data(rng, np.float64, 0.03)
    kw = dict(norm=norm, eps=eps, n_iter=n_iter, loss=loss,
              track_loss="ce-avg", early_stop=True, **extra)
    with x64():
        want = jax.tree.map(np.asarray, japgd.apgd_attack(
            jfn, _nhwc(x), jnp.asarray(y.astype(np.int32)), **kw))
    got = tapgd.apgd_attack(tfn, _t(x), _t(y), **kw)
    return got, want, x


def _compare(got, want, atol):
    for name in ("x_best", "x_best_adv"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   _nchw(getattr(want, name)), rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got.loss_best.numpy(), want.loss_best,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.acc.numpy(), want.acc, atol=1e-7)


@pytest.mark.parametrize("eps,n_iter,loss", [(0.5, 25, "mask-ce-avg"),
                                             (2.0, 20, "ce-avg"),
                                             (1.0, 12, "js-avg")])
def test_l2_trajectory_matches_f64(eps, n_iter, loss):
    got, want, x = _run_both("L2", eps, n_iter, loss)
    _compare(got, want, 1e-8)
    d = (got.x_best_adv.numpy() - x).reshape(B, -1)
    assert np.sqrt((d ** 2).sum(1)).max() <= eps + 1e-6


@pytest.mark.parametrize("eps,n_iter,loss", [(4.0, 25, "ce-avg"),
                                             (10.0, 30, "mask-ce-avg")])
def test_l1_loop_matches_f64_on_jax_projection(eps, n_iter, loss,
                                               monkeypatch):
    """The port's L1 loop, step and sparsity controller, fed the JAX
    projection's values: the trajectory tolerance."""
    def jax_projection(x, y, e):
        with x64():
            return _t(_nchw(jp.project_l1_ball_box(
                _nhwc(x.numpy()), _nhwc(y.numpy()), e)))
    monkeypatch.setattr(tapgd, "project_l1_ball_box", jax_projection)
    got, want, x = _run_both("L1", eps, n_iter, loss)
    _compare(got, want, 1e-8)
    d = np.abs(got.x_best_adv.numpy() - x).reshape(B, -1).sum(1)
    assert d.max() <= eps * (1 + 1e-5)


@pytest.mark.parametrize("loss", ["ce-avg", "mask-ce-avg"])
def test_l1_trajectory_matches_f64_first_iterations(loss):
    """With its own float32 projection, over the first 4 iterations (the
    controller runs at every one of them: k = max(int(0.04 n), 1) = 1)."""
    got, want, x = _run_both("L1", 4.0, 4, loss, n_iter_buf=25)
    _compare(got, want, 1e-6)


def test_l1_is_train_starts_sparser():
    """``is_train`` sets the first sparsity to 0.05 (JAX's)."""
    got, want, _ = _run_both("L1", 4.0, 3, "ce-avg", is_train=True,
                             n_iter_buf=25)
    _compare(got, want, 1e-6)


@pytest.mark.parametrize("norm", ["L2", "L1"])
def test_random_start_and_largereps_are_linf_only(norm):
    rng = np.random.default_rng(3)
    jfn, tfn = _models(rng)
    x, y, _ = _data(rng, np.float32, 0.03)
    with pytest.raises(NotImplementedError, match="random start"):
        tapgd.apgd_attack(tfn, _t(x), _t(y), norm=norm, eps=1.0, n_iter=2,
                          use_rs=True)
    with pytest.raises(NotImplementedError):
        japgd.apgd_largereps(jfn, _nhwc(x), jnp.asarray(y.astype(np.int32)),
                             norm=norm, eps=1.0, n_iter=4)
    with pytest.raises(NotImplementedError):
        tapgd.apgd_largereps(tfn, _t(x), _t(y), norm=norm, eps=1.0, n_iter=4)


# ----------------------------------------------------------- targeted restarts

def test_targeted_classes_match_jax(rng):
    k = 5
    lg = rng.normal(size=(2, 4, 6, k))
    y = rng.integers(0, k, (2, 4, 6))
    srt = np.argsort(lg, axis=-1)
    for i in range(4):
        want = np.asarray(japgd.targeted_classes(jnp.asarray(srt),
                                                 jnp.asarray(y), i, 3))
        got = tapgd.targeted_classes(
            torch.argsort(_t(_nchw(lg)), dim=1), _t(y), i, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.any(got.numpy() == y) or i % 3 + 1 == k


@pytest.mark.parametrize("norm,eps,loss", [("Linf", 8 / 255, "ce-targeted"),
                                           ("L2", 0.5, "ce-targeted"),
                                           ("Linf", 8 / 255, "mask-ce-avg")])
def test_apgd_restarts_matches_f64(norm, eps, loss):
    rng = np.random.default_rng(4)
    jfn, tfn = _models(rng)
    x, y, _ = _data(rng, np.float64, 0.03)
    kw = dict(norm=norm, eps=eps, n_iter=10, loss=loss, n_restarts=2,
              track_loss="ce-avg", early_stop=True, n_target_classes=C)
    with x64():
        jx, _, jacc = japgd.apgd_restarts(
            jfn, _nhwc(x), jnp.asarray(y.astype(np.int32)), **kw)
        jx, jacc = np.asarray(jx), np.asarray(jacc)
    tx, none, tacc = apgd_restarts(tfn, _t(x), _t(y), **kw)
    assert none is None
    np.testing.assert_allclose(tx.numpy(), _nchw(jx), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tacc.numpy(), jacc, atol=1e-7)


# --------------------------------------------------------------------- filters

@pytest.mark.parametrize("alpha_reg", [0.0, 0.05])
def test_pgd_filters_matches_f64(alpha_reg):
    rng = np.random.default_rng(5)
    jfn, tfn = _models(rng)
    x, y, _ = _data(rng, np.float64, 0.03)
    y_img = np.array([0, 2, 1])
    f0 = rng.random((3, 3, 3))
    f0[0, 0, 0] = 0.0  # |f| at exactly 0: a zero subgradient in both
    kw = dict(n_iter=4, alpha=0.2, loss="ce", n_cls=3, alpha_reg=alpha_reg)
    with x64():
        jx, jf = j_filters(jfn, _nhwc(x), jnp.asarray(y.astype(np.int32)),
                           jnp.asarray(y_img), init_f=jnp.asarray(f0), **kw)
        jx, jf = np.asarray(jx), np.asarray(jf)
    tx, tf = pgd_filters(tfn, _t(x), _t(y), _t(y_img), init_f=_t(f0), **kw)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tx.numpy(), _nchw(jx), rtol=0, atol=1e-8)
    # the image comes from the filters before their last update
    assert not np.allclose(tf.numpy(), f0)


# ------------------------------------------------------ the loader and metrics

def test_run_attack_over_loader_matches_f64():
    rng = np.random.default_rng(6)
    jfn, tfn = _models(rng)
    xs = rng.random((3, 3, 10, 12))
    ys = rng.integers(0, C, (3, 10, 12))
    ys[0, :2] = -1
    w = (rng.random(C) + 0.5).astype(np.float32)
    batches = [(xs[:2], ys[:2]), (xs[2:], ys[2:])]  # a padded tail batch
    kw = dict(loss="mask-ce-bal", eps=8 / 255, n_iter=10, weights=w,
              use_rs=False, seed=3)
    with x64():
        want = j_loader(jfn, [(np.moveaxis(a, 1, -1), b.astype(np.int32))
                              for a, b in batches], **kw)
        want = [(np.asarray(a), np.asarray(b)) for a, b in want]
    got = run_attack_over_loader(tfn, batches, **kw)
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_allclose(gx, _nchw(wx), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(gy, wy)
    for norm in ("L2", "L1"):  # apgd_largereps projects in Linf only
        with pytest.raises(NotImplementedError):
            run_attack_over_loader(tfn, batches, **{**kw, "norm": norm})
