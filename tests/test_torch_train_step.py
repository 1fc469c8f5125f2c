"""The port's train and eval steps against JAX's ``make_train_step`` and
``make_eval_step`` on a 1-device mesh, on the CPU: ``PSPNet(classes=5,
dropout=0.0)`` at 17^2, batch 2, the same seeded random weights
(``test_torch_train_models._init``; through ``robseg_torch.convert``), SGD with PSPNet's x10 head scales and a poly
schedule (the family's optimizer), two steps. Both packages' PSPNet
build their ResNet-50 with one bottleneck a stage at the full widths
(``ResNetStages`` patched with ``layers=(1, 1, 1, 1)`` by pytest's
``monkeypatch``), which keeps XLA's compile of the float64 train step
short.

Both sides run in float64 (JAX with x64 on, reset after; the port's
module in double): in float32 the train-mode gradients of this random-init
ResNet-50 (BatchNorms over 2 to 50 values a channel, ReLU gates) move by
up to ~20% of a tensor's largest entry between float32 and float64 in
either framework alone, while in float64 the two frameworks' gradients
agree to ~6e-11. The JAX PGD body keeps its running best loss in a
float32 carry (``jnp.zeros((bs,), jnp.float32)``), which a float64 loss
cannot enter; the test hands that module a ``jnp`` whose ``zeros`` makes
float64 for it (the port keeps the best loss in the loss's dtype).

Tolerances: the losses rel 1e-5; the parameters and BatchNorm statistics
after two steps within 1e-5 (absolute; the updates are ~1e-2), with the
attack off and with PGD (``n_iters=2``, eps 4/255). The eval step's
confusion matrix exactly (float32).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.attacks import pgd as jpgd
from robseg_tpu.models import pspnet as jpsp
from robseg_tpu.parallel import make_data_mesh, replicate, shard_batch
from robseg_tpu.train import (AttackConfig as JAttack, TrainState,
                              make_eval_step, make_optimizer as j_make_opt,
                              make_train_step)
from robseg_tpu.train.optim import pspnet_lr_scales as j_scales
from robseg_tpu.train.schedules import poly_lr as j_poly
from robseg_torch.convert import pspnet_state_dict_from_jax
from robseg_torch.models import PSPNet
from robseg_torch.models import pspnet as tpsp
from robseg_torch.train import (AttackConfig, Trainer, make_optimizer,
                                pspnet_lr_scales)
from robseg_torch.train.schedules import poly_lr
from test_torch_train_models import _init, two_threads  # noqa: F401

K, HW, B = 5, (17, 17), 2


@pytest.fixture(scope="module")
def one_block_resnets():
    mp = pytest.MonkeyPatch()
    for mod in (jpsp, tpsp):
        mp.setattr(mod, "ResNetStages", functools.partial(
            mod.ResNetStages, layers=(1, 1, 1, 1)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(one_block_resnets):
    jm = jpsp.PSPNet(classes=K, dropout=0.0)
    params, stats = _init(jm, HW, labels=jnp.zeros((1,) + HW, jnp.int32))
    rng = np.random.default_rng(0)
    x = rng.random((B,) + HW + (3,)).astype(np.float32)
    y = rng.integers(0, K, (B,) + HW)
    return jm, params, stats, x, y


class _Float64Zeros:
    """``jnp`` with ``zeros(..., float32)`` made float64."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def zeros(shape, dtype=None):
        return jnp.zeros(shape, jnp.float64 if dtype == jnp.float32
                         else dtype)


def _jax_run(setup, attack, monkeypatch):
    jm, params, stats, x, y = setup
    monkeypatch.setattr(jpgd, "jnp", _Float64Zeros())
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        params, stats = f64(params), f64(stats)
        mesh = make_data_mesh(1)
        tx = j_make_opt("sgd", params, j_poly(1e-2, 10), weight_decay=1e-4,
                        lr_scales=j_scales(params))
        state = TrainState(step=jnp.asarray(0), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1))
        step = make_train_step(jm, "PSPNet", tx, mesh, attack)
        state = replicate(mesh, state)
        bx, by = shard_batch(mesh, (x.astype(np.float64),
                                    y.astype(np.int32)))
        losses = []
        for _ in range(2):
            state, metrics = step(state, bx, by)
            losses.append(float(metrics["loss"]))
        state = jax.device_get(state)
    finally:
        jax.config.update("jax_enable_x64", False)
    return losses, pspnet_state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), True)


def _port_run(setup, attack):
    _, params, stats, x, y = setup
    m = PSPNet(classes=K, dropout=0.0)
    m.load_state_dict(pspnet_state_dict_from_jax(params, stats, True))
    m.double()
    opt = make_optimizer("sgd", m, poly_lr(1e-2, 10), weight_decay=1e-4,
                         lr_scales=pspnet_lr_scales(m))
    trainer = Trainer(m, "PSPNet", opt, attack)
    xt = torch.tensor(np.moveaxis(x, -1, 1)).double()
    yt = torch.tensor(y)
    losses = [float(trainer.train_step(xt, yt)) for _ in range(2)]
    assert trainer.step == 2
    return losses, m.state_dict()


@pytest.mark.parametrize("attack_on", [False, True])
def test_two_steps_match_jax(setup, attack_on, monkeypatch):
    tol = 1e-5
    kw = dict(enabled=attack_on, eps=4 / 255, n_iters=2)
    lj, want = _jax_run(setup, JAttack(**kw), monkeypatch)
    lt, got = _port_run(setup, AttackConfig(**kw))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    init = pspnet_state_dict_from_jax(setup[1], setup[2], True)
    moved = 0.0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2, k
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=tol,
                                   rtol=0, err_msg=k)
        moved = max(moved, float((v - init[k]).abs().max()))
    assert moved > 100 * tol


def test_eval_step_histogram_exact(setup):
    jm, params, stats, x, y = setup
    mesh = make_data_mesh(1)
    ev = make_eval_step(jm, K, mesh)
    bx, by = shard_batch(mesh, (x, y.astype(np.int32)))
    want = np.asarray(ev(replicate(mesh, params), replicate(mesh, stats),
                         bx, by, replicate(mesh, jnp.zeros((K, K)))))
    m = PSPNet(classes=K, dropout=0.0)
    m.load_state_dict(pspnet_state_dict_from_jax(params, stats, True))
    trainer = Trainer(m, "PSPNet", make_optimizer(
        "sgd", m, poly_lr(1e-2, 10)), AttackConfig(enabled=False))
    hist = trainer.eval_step(torch.tensor(np.moveaxis(x, -1, 1)),
                             torch.tensor(y), torch.zeros(K, K))
    assert np.array_equal(hist.numpy(), want) and want.sum() == B * HW[0] * HW[1]
    assert m.training  # back in train mode after the eval step


def test_unknown_attack_raises():
    m = PSPNet(classes=K, dropout=0.0)
    with pytest.raises(ValueError, match="'pgd' or 'apgd'"):
        Trainer(m, "PSPNet", make_optimizer("sgd", m, poly_lr(1e-2, 10)),
                AttackConfig(name="fgsm"))
