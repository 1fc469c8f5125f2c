"""UperNet-ConvNeXt in train mode (and the train-mode BatchNorm) against
the JAX modules, and the trainer's attack through the block kernels' twin
against the same attack through the plain module; PSPNet, PSPNet-DDCAT
and the Segmenter are in tests/test_torch_train_families.py, with these
helpers.

The port's models in train mode against the JAX modules (``train=True``,
batch statistics mutable), on the CPU, with the same weights (through
``robseg_torch.convert``) and the same numpy inputs.

DropPath and dropout draw from different generators in the two
frameworks, so these tests switch them off on both sides: the ConvNeXt
drop-path rate is patched to 0 in both packages' ``CONVNEXT_SETTINGS``
(pytest ``monkeypatch``; its depths to 1/1/1/1, its widths to 96, 32,
64, 128 and the heads' channels to 32 in the UperNet test),
PSPNet and PSPNet-DDCAT are built with ``dropout=0.0``, the Segmenter with ``drop_path_rate=0`` and its decoder's
dropout 0.1 turned off (flax's ``nn.Dropout`` patched to the identity, the
port's dropout layers' rate set to 0). The dropout layers' own statistics
are tested in tests/test_torch_train.py.

Tolerances: losses rel 1e-5 (the port in float32); each weight gradient
within 1e-4 of its tensor's largest entry and the new BatchNorm running
statistics (EMA decay 0.9 towards the batch mean and the *biased* batch
variance) within 1e-5, both in float64 on both sides (JAX with x64 on,
reset in ``finally``). In float32 these random-init nets, whose train-mode
BatchNorms see few values a channel, move the stem's gradient by ~3e-3 of
its largest entry and deep running variances by ~2e-5 between the two
frameworks; in float64 every gradient agrees to ~4e-12. Gradients that are
zero by construction (a bias that feeds only a train-mode BatchNorm, ~1e-19
in float64) are held against 1e-9 of the largest gradient instead. The
DDCAT train tuple within atol = rtol = 1e-4 (the eval logits' bound,
tests/test_torch_models.py).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.convert.torch2jax import convert_upernet
from robseg_tpu.models import convnext as jconvnext
from robseg_tpu.models import upernet as jupernet
from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_torch.convert import upernet_state_dict_from_jax
from robseg_torch.models import build_model
from robseg_torch.models import convnext as tconvnext
from robseg_torch.models import upernet as tupernet
from robseg_torch.models.layers import BatchNorm2d

K = 21
DDCAT = dict(backbone_layers=(1, 1, 1, 1), backbone_planes=(4, 8, 8, 16),
             head_width=16, aux_width=8)
SEG = dict(image_size=(32, 32), patch_size=16, n_layers=2, d_model=64,
           n_heads=2)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for the port's side: under several test
    workers on one machine the default pools (one thread a core) mostly
    wait on each other. The train test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _randomize_stats(tree, rng):
    draw = {"mean": lambda s: rng.normal(size=s) * 0.1,
            "var": lambda s: rng.uniform(0.5, 1.5, s)}
    return jax.tree_util.tree_map_with_path(
        lambda p, a: draw[str(p[-1].key)](a.shape).astype(a.dtype)
        if str(p[-1].key) in draw else a, tree)


def _init(jm, hw, **kw):
    """Seeded random variables of the JAX module's shapes, drawn in numpy
    (``jax.eval_shape``: no XLA compile of the init): kernels N(0,
    1/fan_in), scales U(0.5, 1.5), other vectors N(0, 0.01); BatchNorm
    statistics drawn at random."""
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1,) + hw + (3,)), **kw)
    rng = np.random.default_rng(0)

    def draw(path, s):
        if str(path[-1].key) == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif len(s.shape) >= 2:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = rng.normal(size=s.shape) * 0.1
        return a.astype(np.float32)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(v.get("batch_stats", {})))
    return (jax.tree_util.tree_map_with_path(draw, dict(v["params"])),
            _randomize_stats(zeros, np.random.default_rng(0)))


def narrow_upernet(monkeypatch):
    """UperNet-ConvNeXt-T_CVST cut small in both packages: drop path off,
    one block a stage, stages 96, 32, 64, 128 wide (JAX's CvSt stem is 48
    -> 96 whatever the dims), heads 32 channels."""
    for table in (jconvnext.CONVNEXT_SETTINGS, tconvnext.CONVNEXT_SETTINGS):
        monkeypatch.setitem(table, "T_CVST",
                            [[1, 1, 1, 1], [96, 32, 64, 128], 64, 0.0])
    for mod in (jupernet, tupernet):
        for head in ("UperNetHead", "UperNetFCNHead"):
            monkeypatch.setattr(mod, head, functools.partial(
                getattr(mod, head), channels=32))


def _inputs(rng, b, hw, k):
    x = rng.random((b,) + hw + (3,)).astype(np.float32)
    y = rng.integers(0, k, (b,) + hw)
    y[0, :3, :5] = -1
    return (jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
            torch.tensor(np.moveaxis(x, -1, 1)), torch.tensor(y))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _check_grads_and_stats(module, want_sd):
    n = 0
    gmax = max(float(want_sd[name].abs().max())
               for name, _ in module.named_parameters())
    for name, p in module.named_parameters():
        g, gj = p.grad.numpy(), want_sd[name].numpy()
        scale = max(np.abs(gj).max(), 1e-9 * gmax)
        assert np.abs(g - gj).max() <= 1e-4 * scale, name
        n += 1
    for name, b in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_sd[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
            n += 1
    return n


def test_upernet_loss_branch_grads_and_running_stats(monkeypatch):
    # cut small in both packages: XLA's float64 convolutions on the CPU
    # are slow
    narrow_upernet(monkeypatch)
    hw = (32, 32)
    jm = JUN(backbone_variant="T_CVST", num_classes=K)
    # the port's init through the JAX package's converter (no XLA compile
    # of the JAX init), BatchNorm statistics drawn at random
    torch.manual_seed(0)
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", K,
                    fused=False)
    params, stats = convert_upernet(
        {k: v.numpy() for k, v in m.state_dict().items()}, "T_CVST")
    stats = _randomize_stats(stats, np.random.default_rng(0))
    xj, yj, xt, yt = _inputs(np.random.default_rng(1), 2, hw, K)

    jax.config.update("jax_enable_x64", True)
    try:
        s64 = _f64(stats)

        def f(p):
            (loss, _), mut = jm.apply(
                {"params": p, "batch_stats": s64}, jnp.asarray(xj,
                                                              jnp.float64),
                labels=yj, train=True, mutable=["batch_stats"],
                rngs={"droppath": jax.random.PRNGKey(2)})
            return loss, mut["batch_stats"]
        (lj, new_stats), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(
            _f64(params))
        lj, gj, new_stats = float(lj), _np(gj), _np(new_stats)
    finally:
        jax.config.update("jax_enable_x64", False)

    m.load_state_dict(upernet_state_dict_from_jax(params, stats, "T_CVST"))
    assert all(dp.rate == 0.0 for dp in m.modules()
               if type(dp).__name__ == "DropPath")
    m.train()
    loss32, logits = m(xt, yt)
    assert logits.shape == (2, K) + hw
    np.testing.assert_allclose(loss32.item(), lj, rtol=1e-5)
    m.load_state_dict(upernet_state_dict_from_jax(params, stats, "T_CVST"))
    m.double()
    loss, _ = m(xt.double(), yt)
    np.testing.assert_allclose(loss.item(), lj, rtol=1e-5)
    loss.backward()
    want = upernet_state_dict_from_jax(gj, new_stats, "T_CVST")
    assert _check_grads_and_stats(m, want) > 90
    bn = m.decode_head.fpn_bottleneck.batch_norm
    assert isinstance(bn, BatchNorm2d) and int(bn.num_batches_tracked) == 1


def test_upernet_fused_settings_refuse_train_mode(monkeypatch):
    """The block kernels (``fused_mlp=True``) and the folded-BatchNorm
    heads (``"split"``, ``"pallas"``) raise in train mode."""
    narrow_upernet(monkeypatch)
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", 5,
                    fused=False).train()
    blocks = [b for s in m.backbone.stages for b in s]
    for fused_mlp, head in ((True, False), (False, "split"),
                            (False, "pallas")):
        for b in blocks:
            b.fused_mlp = fused_mlp
        m.decode_head.fused_head = head
        with pytest.raises(RuntimeError, match="eval mode only"):
            m(torch.zeros(1, 3, 32, 32))


def test_batchnorm_running_var_is_biased():
    """EMA 0.9 towards the batch mean and the biased batch variance, in
    the two forms (n >= 2 through F.batch_norm, n = 1 by hand)."""
    torch.manual_seed(0)
    for shape in ((3, 4, 5, 2), (1, 4, 1, 1)):
        bn = BatchNorm2d(4).train()
        x = torch.randn(shape)
        y = bn(x)
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_mean, 0.1 * mean)
        torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
        want = (x - mean[:, None, None]) / torch.sqrt(
            var[:, None, None] + 1e-5)
        torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


def test_twin_attack_equals_plain_module_attack(monkeypatch):
    """The trainer's attack through the block kernels' twin (built on the
    meta device, fed the step's parameters and BatchNorm statistics by
    ``functional_call``; on the CPU each kernel wrapper runs its plain
    version) against the same attack through the plain module, after a
    train step moved the weights and statistics: logits within atol =
    rtol = 1e-5, the input gradient of the PGD loss within 1e-5 of its
    largest entry, and PGD-3's adversarial images equal (|diff| <= 1e-6)
    except on at most 0.1% of the entries (the PGD tests' bound in
    tests/test_torch_train.py); no parameter's ``.grad`` is touched."""
    from robseg_torch.attacks.pgd import TRAIN_ATTACK_LOSSES
    from robseg_torch.train import AttackConfig, Trainer, make_optimizer
    narrow_upernet(monkeypatch)
    name = "UperNetForSemanticSegmentation"
    torch.manual_seed(0)
    m = build_model(name, "ConvNeXt-T_CVST", K, fused=False)
    with torch.device("meta"):
        twin = build_model(name, "ConvNeXt-T_CVST", K, fused=True)
    trainer = Trainer(m, name, make_optimizer("adamw", m, lambda s: 1e-2),
                      AttackConfig(eps=4 / 255, n_iters=3), twin=twin)
    _, _, x, y = _inputs(np.random.default_rng(5), 2, (64, 64), K)
    trainer.train_step(x, y)  # the twin must see the moved weights
    trainer.optimizer.zero_grad()

    def logits_and_grad():
        with trainer.attack_model() as lf:
            xg = x.clone().requires_grad_(True)
            logits = lf(xg)
            loss = TRAIN_ATTACK_LOSSES["pgd"](logits, y)
            return logits.detach(), torch.autograd.grad(loss, xg)[0]

    lt, gt = logits_and_grad()
    xt = trainer.attack(x, y)
    trainer.twin = None
    lp, gp = logits_and_grad()
    xp = trainer.attack(x, y)
    assert m.training
    assert all(p.grad is None for p in m.parameters())
    torch.testing.assert_close(lt, lp, atol=1e-5, rtol=1e-5)
    assert float((gt - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    diff = (xt - xp).abs() > 1e-6
    assert float(diff.float().mean()) <= 1e-3, int(diff.sum())
    assert float((xt - x).abs().max()) <= 4 / 255 + 1e-6
