"""The full-width UperNet-ConvNeXt-T_CVST (21 classes): the weight bridge
in both directions, and the port's logits and input gradient against the
JAX model with the same weights.

Tolerances: weights exact; logits rtol = atol = 1e-4 (float32 convolutions
summed in another order); the input gradient of sum(mask-ce-avg) within a
max abs error of 1e-3 * max|g|.

The fused-variant settings (``fused_head="pallas"`` with an MLP-tail
mode) against the JAX model without kernels, under the JAX package's
model-level bounds: logits atol = rtol = 3e-2 and the input gradient of a
fixed random cotangent within 0.05 * max|g| with float32 MLP operands
(tests/test_kernels.py:432-438); 0.15 * max|g| and cosine >= 0.99 with
bf16 ones (:313-318).
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.convert.torch2jax import convert_upernet
from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_tpu.ops.losses import ATTACK_CRITERIA as J_CRIT
from robseg_torch.convert import upernet_state_dict_from_jax
from robseg_torch import bench_fused
from robseg_torch.models import ModelBundle, build_model
from robseg_torch.models.upernet import UperNetForSemanticSegmentation
from robseg_torch.ops.losses import ATTACK_CRITERIA

VARIANT = "T_CVST"
K = 21
HW = 64


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _randomize(tree, rng, names):
    """Replace the BatchNorm statistics / layer scales named in ``names``
    (init gives them constants) with random values."""
    draw = {"mean": lambda s: rng.normal(size=s) * 0.1,
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "gamma": lambda s: rng.uniform(0.2, 1.0, s)}

    def f(path, a):
        leaf = str(path[-1].key)
        if leaf in names:
            return draw[leaf](a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def jax_vars():
    """JAX init with random BatchNorm statistics. The layer scales keep
    their init value 1: random ones as well make this random-weight net so
    ill-conditioned that float32 input gradients of either framework
    differ from the float64 gradient by ~1e-3 relative."""
    v = jax.jit(JUN(backbone_variant=VARIANT, num_classes=K).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    rng = np.random.default_rng(0)
    return (_np_tree(dict(v["params"])),
            _randomize(_np_tree(dict(v["batch_stats"])), rng,
                       ("mean", "var")))


def _port(params, stats):
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-" + VARIANT,
                    K)
    m.load_state_dict(upernet_state_dict_from_jax(params, stats, VARIANT),
                      strict=True)
    return m


@pytest.fixture(scope="module")
def port_model(jax_vars):
    return _port(*jax_vars)


def test_weights_round_trip_exact(jax_vars):
    params = _randomize(jax_vars[0], np.random.default_rng(1), ("gamma",))
    stats = jax_vars[1]
    sd = {k: v.numpy() for k, v in _port(params, stats).state_dict().items()}
    p2, s2 = convert_upernet(sd, VARIANT)
    for want, got in ((params, p2), (stats, s2)):
        fw = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        fg = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert fw.keys() == fg.keys()
        for key, a in fw.items():
            b = fg[key]
            assert a.dtype == b.dtype and np.array_equal(a, b), key


def test_logits_and_input_grad_match_jax(jax_vars, port_model):
    rng = np.random.default_rng(1)
    x = rng.random((1, 3, HW, HW)).astype(np.float32)
    y = rng.integers(0, K, (1, HW, HW))
    y[0, :5, :9] = -1
    v = {"params": jax_vars[0], "batch_stats": jax_vars[1]}
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    yj = jnp.asarray(y.astype(np.int32))
    crit = J_CRIT["mask-ce-avg"]
    jm = JUN(backbone_variant=VARIANT, num_classes=K)

    logits_fn = ModelBundle(port_model).logits_fn
    xt = torch.tensor(x, requires_grad=True)
    lt = logits_fn(xt)
    # labels the model gets right on about half the pixels, so the
    # mask-ce-avg mask is non-trivial; near-ties of the top two logits
    # (random weights give many) would let the two frameworks' argmax
    # disagree, so those pixels get the lowest-scoring class instead
    top2 = np.sort(lt.detach().numpy(), axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-3
    pick = sure & (rng.random(y.shape) < 0.5)
    y = np.where(pick, lt.argmax(1).numpy(), lt.argmin(1).numpy())
    y[0, :5, :9] = -1
    yj = jnp.asarray(y.astype(np.int32))

    def jloss(z):
        lg = jm.apply(v, z)
        return crit(lg, yj).sum(), lg

    (_, lj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(xj)
    np.testing.assert_allclose(lt.detach().numpy(),
                               np.moveaxis(np.asarray(lj), -1, 1),
                               rtol=1e-4, atol=1e-4)
    ATTACK_CRITERIA["mask-ce-avg"](lt, torch.tensor(y)).sum().backward()
    gj = np.moveaxis(np.asarray(gj), -1, 1)
    g = xt.grad.numpy()
    assert np.abs(g - gj).max() <= 1e-3 * np.abs(gj).max()

    # the port's split bottleneck against the JAX split head on XLA
    lj_split = jax.jit(JUN(backbone_variant=VARIANT, num_classes=K,
                           fused_head="split").apply)(v, xj)
    np.testing.assert_allclose(lt.detach().numpy(),
                               np.moveaxis(np.asarray(lj_split), -1, 1),
                               rtol=1e-4, atol=1e-4)


def test_train_mode_raises(port_model):
    port_model.train()
    try:
        with pytest.raises(RuntimeError, match="eval mode only"):
            port_model(torch.zeros(1, 3, 32, 32))
    finally:
        port_model.eval()


def test_other_models_name_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        build_model("SegMenter", "vit_small_patch16_384", 21)


def test_fused_settings_keep_the_parameters(jax_vars):
    """Every fused setting has the main path's parameter tree, so
    ``upernet_state_dict_from_jax`` carries weights into any of them."""
    sd = upernet_state_dict_from_jax(*jax_vars, VARIANT)
    for kw in (dict(fused_mlp_mode="residual", fused_head="pallas"),
               dict(fused_mlp=False, fused_head=False)):
        m = UperNetForSemanticSegmentation(VARIANT, K, **kw)
        assert m.state_dict().keys() == sd.keys()
        m.load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def jax_plain_vjp(jax_vars):
    """The JAX model without kernels: logits and the input gradient of a
    fixed random cotangent, at 64^2."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 3, HW, HW)).astype(np.float32)
    ct = rng.normal(size=(1, K, HW, HW)).astype(np.float32)
    v = {"params": jax_vars[0], "batch_stats": jax_vars[1]}
    jm = JUN(backbone_variant=VARIANT, num_classes=K)

    @jax.jit
    def f(z, c):
        lg, vjp = jax.vjp(lambda a: jm.apply(v, a), z)
        return lg, vjp(c)[0]

    lj, gj = f(jnp.asarray(np.moveaxis(x, 1, -1)),
               jnp.asarray(np.moveaxis(ct, 1, -1)))
    return (x, ct, np.moveaxis(np.asarray(lj), -1, 1),
            np.moveaxis(np.asarray(gj), -1, 1))


@pytest.mark.parametrize("mode", ["residual", "recompute_bf16"])
def test_fused_settings_match_jax_without_kernels(jax_vars, jax_plain_vjp,
                                                  mode):
    x, ct, lj, gj = jax_plain_vjp
    m = UperNetForSemanticSegmentation(VARIANT, K, fused_mlp_mode=mode,
                                       fused_head="pallas")
    m.load_state_dict(upernet_state_dict_from_jax(*jax_vars, VARIANT),
                      strict=True)
    xt = torch.tensor(x, requires_grad=True)
    lt = ModelBundle(m).logits_fn(xt)
    (lt * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(lt.detach().numpy(), lj, atol=3e-2,
                               rtol=3e-2)
    g = xt.grad.numpy()
    err = np.abs(g - gj).max() / np.abs(gj).max()
    if mode.endswith("_bf16"):
        cos = float((g * gj).sum() / np.linalg.norm(g) / np.linalg.norm(gj))
        assert err < 0.15 and cos >= 0.99, (err, cos)
    else:
        assert err < 0.05, err


def test_bench_fused_entry_point_on_cpu(capsys):
    bench_fused.main(["--device", "cpu", "--hw", "32", "--batch", "1",
                      "--n_iter", "1", "--modes", "rs,head",
                      "--skip_backbone"])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert sorted(res) == sorted(
        f"{k}_{m}" for k in ("attack_step_imgs_per_s", "attack_acc")
        for m in ("rs", "head"))
    assert all(0.0 <= res[f"attack_acc_{m}"] <= 1.0 for m in ("rs", "head"))
    assert lines[-2].startswith("kernel launches: ")


def test_bench_fused_bf16_on_cpu(capsys):
    """``--bf16`` (bf16 parameters and activations) in a tail mode, whose
    float32 output promotes every later layer (the FPN kernel's bf16 form
    is held against JAX in tests/test_torch_precision.py); it replaces the
    refusal this flag met before the bf16 path was ported."""
    bench_fused.main(["--device", "cpu", "--hw", "32", "--batch", "1",
                      "--n_iter", "1", "--modes", "rs", "--skip_backbone",
                      "--bf16"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["attack_acc_rs", "attack_step_imgs_per_s_rs"]
    assert 0.0 <= res["attack_acc_rs"] <= 1.0
