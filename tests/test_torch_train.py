"""PIR-AT's building blocks in the port against the JAX package, on the CPU:
schedules, optimizers, train losses, the training PGD attacks, the TRAIN
settings, and the dropout layers' statistics.

Tolerances:
  * schedules: rel 1e-6, or abs 1e-7 of the base lr where the JAX
    function's float32 arithmetic cancels (the cosine near its end; the
    port computes in float64);
  * the decay mask, lr scales and freeze mask over the port's named
    parameters: equal to JAX's trees mapped through the weight bridge
    (``robseg_torch.convert``);
  * three AdamW / SGD steps on shared parameters and gradients: within
    1e-6 of optax; frozen parameters bit-identical;
  * train losses: rel 1e-5;
  * PGD: the adversarial images equal (|diff| <= 1e-6) except on at most
    0.1% of the entries, where ``sign`` meets a gradient that the two
    frameworks round to different sides of zero.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn as nn
import jax
import jax.numpy as jnp
import optax
import yaml

from robseg_tpu import config as jcfg
from robseg_tpu.attacks import pgd as jpgd
from robseg_tpu.models import convnext as jconvnext
from robseg_tpu.models import pspnet as jpsp
from robseg_tpu.models.segmenter import SegMenter as JSeg
from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_tpu.ops import losses as jlosses
from robseg_tpu.train import optim as joptim
from robseg_tpu.train import schedules as jsched
from robseg_torch.attacks import pgd as tpgd
from robseg_torch.config import TrainSettings
from robseg_torch.convert import (pspnet_state_dict_from_jax,
                                  segmenter_state_dict_from_jax,
                                  upernet_state_dict_from_jax)
from robseg_torch.models import PSPNet, SegMenter, build_model
from robseg_torch.models import convnext as tconvnext
from robseg_torch.models import pspnet as tpsp
from robseg_torch.models.layers import DropPath, Dropout, Dropout2d
from robseg_torch.ops import losses as tlosses
from robseg_torch.train import optim as toptim
from robseg_torch.train import schedules as tsched
from test_torch_train_models import two_threads  # noqa: F401

SEG = dict(image_size=(32, 32), patch_size=16, n_layers=2, d_model=64,
           n_heads=2)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["warmuppolylr", "warmupcosinelr", "polylr",
                                  "warmupsteplr", "warmuplr"])
def test_schedules_match_jax(name):
    j = jsched.get_scheduler(name, 0.01, 50, 0.9, 10, 1e-5)
    t = tsched.get_scheduler(name, 0.01, 50, 0.9, 10, 1e-5)
    for s in range(50):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6,
                                   atol=1e-7 * 0.01)


def test_timm_and_raw_poly_match_jax():
    for warm in (0, 7):
        j = jsched.polynomial_lr_timm(1e-3, 50, 0.9, warm, 1e-5)
        t = tsched.polynomial_lr_timm(1e-3, 50, 0.9, warm, 1e-5)
        for s in range(50):
            np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6)
    for s in range(50):
        np.testing.assert_allclose(
            tsched.poly_learning_rate(0.01, s, 50),
            float(jsched.poly_learning_rate(0.01, s, 50)), rtol=1e-6)
    with pytest.raises(ValueError):
        tsched.get_scheduler("nope", 0.01, 50, 0.9, 10, 1e-5)


# ------------------------------------------------------ optimizer groupings

def _shapes(jmodule, *args, **kw):
    v = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *args, **kw)
    return (jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(v["params"])),
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(v.get("batch_stats", {}))))


def _fill(mask_tree, params):
    """A JAX per-leaf value tree -> arrays of the leaf shapes filled with
    it, so the weight bridge can carry it to the port's names."""
    return jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                        mask_tree, params)


def _bridged(sd, module, want):
    """Every named parameter's bridged value (constant tensor) equals
    ``want[name]``."""
    names = [n for n, _ in module.named_parameters()]
    assert set(names) == set(want)
    for n in names:
        v = sd[n]
        assert torch.all(v == v.flatten()[0]), n
        assert float(v.flatten()[0]) == pytest.approx(float(want[n])), n


def _cases():
    jun = JUN(backbone_variant="T_CVST", num_classes=21)
    up, us = _shapes(jun, jnp.zeros((1, 32, 32, 3)))
    pp, ps = _shapes(jpsp.PSPNet(classes=21), jnp.zeros((1, 33, 33, 3)))
    sp, _ = _shapes(JSeg(n_cls=21, **SEG), jnp.zeros((1, 32, 32, 3)))
    with torch.device("meta"):  # names and shapes only
        tun = build_model("UperNetForSemanticSegmentation",
                          "ConvNeXt-T_CVST", 21, fused=False)
        tpn, tseg = PSPNet(classes=21), SegMenter(21, **SEG)
    return {
        "upernet": (up, tun, lambda t: upernet_state_dict_from_jax(
            t, us, "T_CVST")),
        "pspnet": (pp, tpn, lambda t: pspnet_state_dict_from_jax(t, ps, True)),
        "segmenter": (sp, tseg, lambda t: segmenter_state_dict_from_jax(t, 2)),
    }


@pytest.fixture(scope="module")
def cases():
    """The three families at small size in both packages: ConvNeXt with
    1/1/2/1 blocks and stages 96, 32, 64, 128 wide (the aux head's input
    64; every layer group of the layer-wise scales), ResNet-50 with one
    bottleneck a stage."""
    mp = pytest.MonkeyPatch()
    for table in (jconvnext.CONVNEXT_SETTINGS, tconvnext.CONVNEXT_SETTINGS):
        mp.setitem(table, "T_CVST", [[1, 1, 2, 1], [96, 32, 64, 128], 64,
                                     table["T_CVST"][3]])
    for mod in (jpsp, tpsp):
        mp.setattr(mod, "ResNetStages", functools.partial(
            mod.ResNetStages, layers=(1, 1, 1, 1)))
    try:
        yield _cases()
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["upernet", "pspnet", "segmenter"])
def test_decay_mask_matches_jax(cases, name):
    params, module, to_sd = cases[name]
    _bridged(to_sd(_fill(joptim.decay_mask(params), params)), module,
             toptim.decay_mask(module))


@pytest.mark.parametrize("name", ["upernet", "pspnet", "segmenter"])
def test_lr_scales_and_freeze_mask_match_jax(cases, name):
    params, module, to_sd = cases[name]
    _bridged(to_sd(_fill(joptim.pspnet_lr_scales(params), params)), module,
             toptim.pspnet_lr_scales(module))
    _bridged(to_sd(_fill(joptim.layerwise_lr_scales(params), params)),
             module, toptim.layerwise_lr_scales(module))
    if name == "segmenter":
        with pytest.raises(ValueError):
            joptim.freeze_mask(params)
        with pytest.raises(ValueError, match="no backbone"):
            toptim.freeze_mask(module)
    else:
        _bridged(to_sd(_fill(joptim.freeze_mask(params), params)), module,
                 toptim.freeze_mask(module))


class _Toy(nn.Module):
    """Parameters named like a segmentation net's: a backbone and new
    modules, 1-D and 4-D ones, a 4-D one with "norm" in its name."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.conv = nn.Conv2d(3, 4, 3)
        self.backbone.norm = nn.LayerNorm(4)
        self.cls = nn.Module()
        self.cls.conv = nn.Conv2d(4, 5, 1)
        self.cls.norm_proj = nn.Conv2d(5, 5, 1, bias=False)


def _jax_tree(module):
    tree = {}
    for n, p in module.named_parameters():
        top, rest = n.split(".", 1)
        tree.setdefault(top, {})[rest] = jnp.asarray(p.detach().numpy())
    return tree


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("variant", ["plain", "pspnet_scales", "frozen"])
def test_three_steps_match_optax(opt_name, variant):
    torch.manual_seed(0)
    module = _Toy()
    params = _jax_tree(module)
    sched_j = jsched.warmup_poly_lr(1e-2, 1.0, 10, 2, 1e-3)
    sched_t = tsched.warmup_poly_lr(1e-2, 1.0, 10, 2, 1e-3)
    kw_j, kw_t = {}, {}
    if variant == "pspnet_scales":
        kw_j["lr_scales"] = joptim.pspnet_lr_scales(params)
        kw_t["lr_scales"] = toptim.pspnet_lr_scales(module)
    if variant == "frozen":
        kw_j["frozen_mask"] = joptim.freeze_mask(params)
        kw_t["frozen_mask"] = toptim.freeze_mask(module)
    tx = joptim.make_optimizer(opt_name, params, sched_j, weight_decay=0.05,
                               **kw_j)
    opt = toptim.make_optimizer(opt_name, module, sched_t,
                                weight_decay=0.05, **kw_t)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    state = tx.init(params)
    rng = np.random.default_rng(0)
    for i in range(3):
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in module.named_parameters()}
        gj = {top: {rest: jnp.asarray(grads[f"{top}.{rest}"])
                    for rest in sub} for top, sub in params.items()}
        upd, state = tx.update(gj, state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        for n, p in module.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        opt.step(i)
    for n, p in module.named_parameters():
        top, rest = n.split(".", 1)
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[top][rest]), atol=1e-6,
                                   rtol=0, err_msg=n)
        if variant == "frozen" and top == "backbone":
            assert torch.equal(p.detach(), before[n]), n
        else:
            assert not torch.equal(p.detach(), before[n]), n


# -------------------------------------------------------------- train losses

def _logits(rng, b=2, k=5, h=6, w=7):
    lg = rng.normal(size=(b, h, w, k)).astype(np.float32) * 2
    y = rng.integers(0, k, (b, h, w))
    y[0, :2, :3] = -1
    return lg, y


def _pair(lg, y):
    return (jnp.asarray(lg), jnp.asarray(y.astype(np.int32)),
            torch.tensor(np.moveaxis(lg, -1, 1)), torch.tensor(y))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    lg, y = _logits(rng)
    aux, _ = _logits(rng)
    jl, jy, tl, ty = _pair(lg, y)
    ja, _, ta, _ = _pair(aux, y)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    cases = [
        (jlosses.segmentation_cross_entropy(jl, jy, -1),
         tlosses.segmentation_cross_entropy(tl, ty, -1)),
        (jlosses.segmentation_cross_entropy(jl, jy, -1, jnp.asarray(w)),
         tlosses.segmentation_cross_entropy(tl, ty, -1, torch.tensor(w))),
        (jlosses.segmentation_cross_entropy((jl, ja), jy, -1),
         tlosses.segmentation_cross_entropy((tl, ta), ty, -1)),
        (jlosses.get_train_loss("CrossEntropy", -1, jnp.asarray(w))(jl, jy),
         tlosses.get_train_loss("CrossEntropy", -1, torch.tensor(w))(tl, ty)),
    ]
    for want, got in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    all_ignored = torch.full_like(ty, -1)
    assert float(tlosses.segmentation_cross_entropy(tl, all_ignored)) == 0.0


@pytest.mark.parametrize("thresh", [0.7, 0.05])
def test_ohem_and_dice_match_jax(thresh):
    rng = np.random.default_rng(1)
    lg, y = _logits(rng)
    aux, _ = _logits(rng)
    jl, jy, tl, ty = _pair(lg, y)
    ja, _, ta, _ = _pair(aux, y)
    # Dice works on the raw scores as probabilities: scores in [0, 1]
    # keep its sums of opposite signs from cancelling (then the two
    # frameworks' summation orders differ far beyond rel 1e-5)
    pj, _, pt, _ = _pair(rng.random(lg.shape).astype(np.float32), y)
    qj, _, qt, _ = _pair(rng.random(lg.shape).astype(np.float32), y)
    for want, got in (
            (jlosses.ohem_cross_entropy(jl, jy, -1, thresh),
             tlosses.ohem_cross_entropy(tl, ty, -1, thresh)),
            (jlosses.ohem_cross_entropy((jl, ja), jy, -1, thresh),
             tlosses.ohem_cross_entropy((tl, ta), ty, -1, thresh)),
            (jlosses.dice_loss(pj, jy), tlosses.dice_loss(pt, ty)),
            (jlosses.dice_loss((pj, qj), jy), tlosses.dice_loss((pt, qt), ty)),
            (jlosses.get_train_loss("OhemCrossEntropy")(jl, jy),
             tlosses.get_train_loss("OhemCrossEntropy")(tl, ty)),
            (jlosses.get_train_loss("Dice")(pj, jy),
             tlosses.get_train_loss("Dice")(pt, ty))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        tlosses.get_train_loss("nope")


# ----------------------------------------------------------------------- PGD

def _linear_fns(rng, k):
    """The same per-pixel linear logits function in both frameworks."""
    w = rng.normal(size=(3, k)).astype(np.float32) * 3
    b = rng.normal(size=(k,)).astype(np.float32)
    wj, bj = jnp.asarray(w), jnp.asarray(b)
    wt, bt = torch.tensor(w), torch.tensor(b)
    return (lambda x: jnp.einsum("bhwc,ck->bhwk", x, wj) + bj,
            lambda x: torch.einsum("bchw,ck->bkhw", x, wt)
            + bt[:, None, None])


def _assert_mostly_equal(got, want):
    diff = np.abs(got - want) > 1e-6
    assert diff.mean() <= 1e-3, (diff.sum(), diff.size)


@pytest.mark.parametrize("loss", ["pgd", "mask-ce-avg", "js-avg", "l2-loss",
                                  "segpgd-loss"])
def test_pgd_attack_matches_jax(loss):
    rng = np.random.default_rng(2)
    # l2-loss broadcasts (B, H, W) labels against (B, H, W, K) logits, the
    # JAX expression, so it takes B = 1 and H = W = K
    b, hw, k = (1, 6, 6) if loss == "l2-loss" else (3, 20, 5)
    fj, ft = _linear_fns(rng, k)
    x = rng.random((b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, k, (b, hw, hw))
    want = jpgd.pgd_attack(fj, jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
                           eps=8 / 255, alpha=1e-2, num_iter=4, loss=loss)
    xt = torch.tensor(np.moveaxis(x, -1, 1))
    got = tpgd.pgd_attack(ft, xt, torch.tensor(y), eps=8 / 255, alpha=1e-2,
                          num_iter=4, loss=loss)
    assert not got.requires_grad
    assert float((got - xt).abs().max()) <= 8 / 255 + 1e-6
    _assert_mostly_equal(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))


def test_pgd_attack_rs_matches_jax_with_delta_init():
    rng = np.random.default_rng(3)
    fj, ft = _linear_fns(rng, 5)
    x = rng.random((2, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 5, (2, 16, 16))
    d0 = rng.uniform(-4 / 255, 4 / 255, x.shape).astype(np.float32)
    want = jpgd.pgd_attack_rs(fj, jnp.asarray(x),
                              jnp.asarray(y.astype(np.int32)),
                              jax.random.PRNGKey(0), eps=4 / 255, alpha=1e-2,
                              num_iter=3, loss="mask-ce-avg",
                              delta_init=jnp.asarray(d0))
    got = tpgd.pgd_attack_rs(ft, torch.tensor(np.moveaxis(x, -1, 1)),
                             torch.tensor(y), eps=4 / 255, alpha=1e-2,
                             num_iter=3, loss="mask-ce-avg",
                             delta_init=torch.tensor(np.moveaxis(d0, -1, 1)))
    _assert_mostly_equal(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))
    # the random start: seeded, inside the ball
    xt = torch.tensor(np.moveaxis(x, -1, 1))
    runs = [tpgd.pgd_attack_rs(ft, xt, torch.tensor(y), eps=4 / 255,
                               num_iter=1,
                               generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert float((runs[0] - xt).abs().max()) <= 4 / 255 + 1e-6


def test_pgd_touches_no_parameter_grad():
    lin = nn.Conv2d(3, 4, 1)
    x = torch.rand(2, 3, 8, 8)
    tpgd.pgd_attack(lin, x, torch.randint(0, 4, (2, 8, 8)), num_iter=2)
    assert all(p.grad is None for p in lin.parameters())
    assert set(tpgd.TRAIN_ATTACK_LOSSES) == set(jpgd.TRAIN_ATTACK_LOSSES)


# ------------------------------------------------------------ TRAIN settings

@pytest.mark.parametrize("cfg", ["pascalvoc_convnext.yaml", "voc_pspnet.yaml",
                                 "ade20k_segmenter.yaml", "rig_voc_demo.yaml",
                                 "ade20k_convnext.yaml"])
def test_train_settings_match_jax(cfg):
    with open(f"configs/{cfg}") as f:
        train = yaml.safe_load(f)["TRAIN"]
    for section in (train, {}):
        assert dataclasses.asdict(TrainSettings.from_cfg(section)) == \
            dataclasses.asdict(jcfg.TrainSettings.from_cfg(section))


# -------------------------------------------------------------- dropout RNG

@pytest.mark.parametrize("layer", [DropPath, Dropout2d, Dropout])
def test_dropout_layers_seeded_statistics(layer):
    """Identity in eval and at rate 0; in train a keep/drop mask over the
    layer's unit (sample, channel, element) with keep rate 1 - rate
    (within 4 sigma), the kept values scaled by 1 / keep; the same seed
    gives the same mask."""
    rate, n = 0.3, 4000
    x = torch.ones(n, 8, 3, 3)
    m = layer(rate)
    assert torch.equal(m.eval()(x), x)
    assert torch.equal(layer(0.0).train()(x), x)
    m.train()
    m.generator = torch.Generator().manual_seed(5)
    y = m(x)
    assert bool(((y == 0) | ((y - 1 / 0.7).abs() < 1e-6)).all())
    unit = {DropPath: y[:, :1, :1, :1], Dropout2d: y[:, :, :1, :1],
            Dropout: y}[layer]
    if layer is DropPath:
        assert bool((y == y[:, :1, :1, :1]).all())
    if layer is Dropout2d:
        assert bool((y == y[:, :, :1, :1]).all())
    dropped = float((unit == 0).float().mean())
    sigma = (rate * (1 - rate) / unit.numel()) ** 0.5
    assert abs(dropped - rate) <= 4 * sigma
    m.generator = torch.Generator().manual_seed(5)
    assert torch.equal(m(x), y)
    m.generator = torch.Generator().manual_seed(6)
    assert not torch.equal(m(x), y)
