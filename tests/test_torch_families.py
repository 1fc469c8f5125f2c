"""The Segmenter-ViT and PSPNet / PSPNet-DDCAT / DeepLabV3 / DeepLabV3-DDCAT
families of the port against the JAX modules, on the CPU.

The same seeded JAX init (BatchNorm statistics randomised) goes into both
frameworks through ``robseg_torch.convert``; the same numpy inputs go
through both models.

Tolerances (the UperNet test's, tests/test_torch_models.py): weights
exact; logits rtol = atol = 1e-4 (float32 products summed in another
order); the input gradient of sum(mask-ce-avg) within a max abs error of
1e-3 * max|g|.

Sizes: Segmenter with 2 layers, d_model 64, 2 heads, native grid 2 x 2 and
a 40 x 56 input (padded to 48 x 64, so both the pad path and the position
embedding's resize run), with and without the distillation token; PSPNet
at full ResNet-50 width on 33 x 33 with both stems; PSPNet-DDCAT at one
bottleneck a stage with planes (4, 8, 8, 16) and head widths 16 / 8 (the
JAX module's geometry fields; one block a stage is the least its
``backbone_layers`` takes, and planes this narrow keep the test fast);
DeepLabV3 and DeepLabV3-DDCAT, which have no such fields in JAX, at full
width on 17 x 17.

Also: the weight round trips JAX -> port -> ``convert_segmenter`` /
``convert_pspnet`` -> JAX; the ``--precision bf16`` dtype trail against
``jax.eval_shape`` of the JAX model's intermediates; ADE20K val data
against the JAX dataset; the CLI's model build and ``.pth`` loading.
PSPNet-DDCAT and the DeepLab models' logits, input gradients and dtype
trail are checked in tests/test_torch_families_deeplab.py, with this
file's helpers, so the two halves run on two test workers.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from robseg_tpu.convert.torch2jax import convert_pspnet, convert_segmenter
from robseg_tpu.models import pspnet as jpsp
from robseg_tpu.models.segmenter import SegMenter as JSeg
from robseg_tpu.ops.losses import ATTACK_CRITERIA as J_CRIT
from robseg_torch import infer
from robseg_torch.convert import (ddcat_state_dict_from_jax,
                                  deeplab_state_dict_from_jax,
                                  pspnet_state_dict_from_jax,
                                  segmenter_state_dict_from_jax)
from robseg_torch.models import (DeepLabV3, DeepLabV3DDCAT, ModelBundle,
                                 PSPNet, PSPNetDDCAT, SegMenter)
from robseg_torch.ops.losses import ATTACK_CRITERIA

K = 21
BF16 = torch.bfloat16
SEG = dict(image_size=(32, 32), patch_size=16, n_layers=2, d_model=64,
           n_heads=2)
DDCAT = dict(backbone_layers=(1, 1, 1, 1), backbone_planes=(4, 8, 8, 16),
             head_width=16, aux_width=8)

# name: (JAX module, port module, JAX variables -> port state_dict, input)
CASES = {
    "segmenter": (lambda: JSeg(n_cls=K, **SEG),
                  lambda: SegMenter(K, **SEG),
                  lambda p, s: segmenter_state_dict_from_jax(p, 2, False),
                  (40, 56)),
    "segmenter_distilled": (
        lambda: JSeg(n_cls=K, distilled=True, **SEG),
        lambda: SegMenter(K, distilled=True, **SEG),
        lambda p, s: segmenter_state_dict_from_jax(p, 2, True), (40, 56)),
    "pspnet_deep_base": (lambda: jpsp.PSPNet(classes=K, deep_base=True),
                         lambda: PSPNet(K, deep_base=True),
                         lambda p, s: pspnet_state_dict_from_jax(p, s, True),
                         (33, 33)),
    "pspnet_7x7_stem": (lambda: jpsp.PSPNet(classes=K, deep_base=False),
                        lambda: PSPNet(K, deep_base=False),
                        lambda p, s: pspnet_state_dict_from_jax(p, s, False),
                        (33, 33)),
    "pspnet_ddcat": (lambda: jpsp.PSPNetDDCAT(classes=K, **DDCAT),
                     lambda: PSPNetDDCAT(K, **DDCAT),
                     ddcat_state_dict_from_jax, (33, 33)),
    "deeplabv3": (lambda: jpsp.DeepLabV3(classes=K),
                  lambda: DeepLabV3(K),
                  lambda p, s: deeplab_state_dict_from_jax(p, s, True),
                  (17, 17)),
    "deeplabv3_ddcat": (lambda: jpsp.DeepLabV3DDCAT(classes=K),
                        lambda: DeepLabV3DDCAT(K),
                        ddcat_state_dict_from_jax, (17, 17)),
}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _randomize_stats(tree, rng):
    """BatchNorm statistics (init gives zeros and ones) drawn at random."""
    draw = {"mean": lambda s: rng.normal(size=s) * 0.1,
            "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def f(path, a):
        leaf = str(path[-1].key)
        return draw[leaf](a.shape).astype(a.dtype) if leaf in draw else a
    return jax.tree_util.tree_map_with_path(f, tree)


_VARS = {}


def _jax_vars(name):
    """(params, batch_stats) of the JAX model, numpy, cached per case."""
    if name not in _VARS:
        jm, _, _, hw = CASES[name]
        v = jax.jit(jm().init)(jax.random.PRNGKey(0),
                               jnp.zeros((1,) + hw + (3,)))
        _VARS[name] = (_np_tree(dict(v["params"])), _randomize_stats(
            _np_tree(dict(v.get("batch_stats", {}))),
            np.random.default_rng(0)))
    return _VARS[name]


def _port(name):
    _, pm, to_sd, _ = CASES[name]
    m = pm()
    m.load_state_dict(to_sd(*_jax_vars(name)), strict=True)
    return m.eval()


def _assert_trees_equal(want, got):
    fw = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    fg = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert fw.keys() == fg.keys()
    for key, a in fw.items():
        b = fg[key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def check_logits_and_input_grad(name):
    """The port's logits and input gradient of sum(mask-ce-avg) against
    the JAX model's, on the same weights and input."""
    jm, _, _, hw = CASES[name]
    params, stats = _jax_vars(name)
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    rng = np.random.default_rng(1)
    x = rng.random((1, 3) + hw).astype(np.float32)
    m = _port(name)
    xt = torch.tensor(x, requires_grad=True)
    lt = ModelBundle(m).logits_fn(xt)
    assert lt.shape == (1, K) + hw
    # labels the model gets right on about half the pixels (a non-empty
    # mask-ce-avg mask); near-ties of the top two logits would let the
    # frameworks' argmax disagree, so those get the lowest-scoring class
    top2 = np.sort(lt.detach().numpy(), axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-3
    pick = sure & (rng.random((1,) + hw) < 0.5)
    y = np.where(pick, lt.argmax(1).numpy(), lt.argmin(1).numpy())
    y[0, :3, :4] = -1
    yj = jnp.asarray(y.astype(np.int32))
    crit = J_CRIT["mask-ce-avg"]
    module = jm()

    def jloss(z):
        lg = module.apply(v, z)
        return crit(lg, yj).sum(), lg

    (_, lj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(np.moveaxis(x, 1, -1)))
    np.testing.assert_allclose(lt.detach().numpy(),
                               np.moveaxis(np.asarray(lj), -1, 1),
                               rtol=1e-4, atol=1e-4)
    ATTACK_CRITERIA["mask-ce-avg"](lt, torch.tensor(y)).sum().backward()
    gj = np.moveaxis(np.asarray(gj), -1, 1)
    g = xt.grad.numpy()
    assert np.abs(gj).max() > 0
    assert np.abs(g - gj).max() <= 1e-3 * np.abs(gj).max()


# PSPNet-DDCAT and the DeepLab models: tests/test_torch_families_deeplab.py
@pytest.mark.parametrize("name", ["segmenter", "segmenter_distilled",
                                  "pspnet_deep_base", "pspnet_7x7_stem"])
def test_logits_and_input_grad_match_jax(name):
    check_logits_and_input_grad(name)


@pytest.mark.parametrize("name", ["segmenter", "segmenter_distilled"])
def test_segmenter_weights_round_trip_exact(name):
    params, _ = _jax_vars(name)
    sd = {k: v.numpy() for k, v in _port(name).state_dict().items()}
    p2, s2 = convert_segmenter(sd, n_layers=2, decoder_layers=2,
                               target_grid=(2, 2))
    assert s2 == {}
    _assert_trees_equal(params, p2)


@pytest.mark.parametrize("deep_base", [True, False])
def test_pspnet_weights_round_trip_exact(deep_base):
    name = "pspnet_deep_base" if deep_base else "pspnet_7x7_stem"
    sd = {k: v.numpy() for k, v in _port(name).state_dict().items()}
    p2, s2 = convert_pspnet(sd, deep_base=deep_base)
    params, stats = _jax_vars(name)
    _assert_trees_equal(params, p2)
    _assert_trees_equal(stats, s2)


def _to_bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == np.float32 else a, tree)


def _jax_trail(name, paths):
    """The dtype of each named intermediate of the JAX model with bf16
    variables on a bf16 input (``jax.eval_shape``: nothing runs)."""
    jm, _, _, hw = CASES[name]
    params, stats = _jax_vars(name)
    v = _to_bf16({"params": params, "batch_stats": stats} if stats
                 else {"params": params})
    out, state = jax.eval_shape(
        lambda z: jm().apply(v, z, capture_intermediates=True,
                             mutable=["intermediates"]),
        jax.ShapeDtypeStruct((1,) + hw + (3,), jnp.bfloat16))
    inter = state["intermediates"]
    trail = {}
    for key, path in paths.items():
        node = inter
        for p in path:
            node = node[p]
        trail[key] = str(node["__call__"][0].dtype)
    trail["out"] = str(out.dtype)
    return trail


@pytest.mark.parametrize("name", ["segmenter", "pspnet_deep_base"])
def test_bf16_dtype_trail_matches_jax(name):
    check_bf16_dtype_trail(name)


def check_bf16_dtype_trail(name):
    """Under ``ModelBundle(module, "bf16")``: the ViT's attention, blocks,
    LayerNorms and decoder, or the ResNet's stem BatchNorm, blocks and
    heads, have JAX's dtype; the bundle returns float32 logits."""
    m = _port(name)
    if name == "segmenter":
        mods = {f"encoder.block{i}": m.encoder.blocks[i] for i in range(2)}
        mods.update({"encoder.block0.attn": m.encoder.blocks[0].attn,
                     "encoder.norm": m.encoder.norm,
                     "decoder.block1": m.decoder.blocks[1],
                     "decoder.mask_norm": m.decoder.mask_norm,
                     "decoder": m.decoder})
    else:
        psp = isinstance(m, PSPNet)   # the reference layout: layer0..4
        bb = m if psp else m.backbone
        mods = {f"backbone.layer{s}_block{b}": getattr(bb, f"layer{s}")[b]
                for s in range(1, 5)
                for b in range(len(getattr(bb, f"layer{s}")))}
        mods["backbone.bn1"] = m.layer0[1] if psp else m.backbone.bn1
        for head in ("ppm", "aspp", "cls", "cls1"):
            if hasattr(m, head):
                mods[head] = getattr(m, head)
    want = _jax_trail(name, {k: tuple(k.split(".")) for k in mods})
    mods["out"] = m
    bundle = ModelBundle(m, "bf16")
    got = {}
    for key, mod in mods.items():
        mod.register_forward_hook(
            lambda _m, _i, out, key=key: got.__setitem__(key, out.dtype))
    with torch.no_grad():
        out = bundle.logits_fn(torch.rand((1, 3) + CASES[name][3]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert {k: str(v).removeprefix("torch.") for k, v in got.items()} == want


def _write_ade_fixture(root, n=3, hw=(40, 52)):
    """images/validation/*.jpg + annotations/validation/*.png, labels
    0..150, plus one image with no annotation (skipped)."""
    base = os.path.join(root, "ADEChallengeData2016")
    img_dir = os.path.join(base, "images", "validation")
    ann_dir = os.path.join(base, "annotations", "validation")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    rng = np.random.default_rng(7)
    for i in range(n):
        stem = f"ADE_val_{i:08d}"
        img = (rng.random(hw + (3,)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, stem + ".jpg"))
        lab = rng.integers(0, 151, (hw[0] // 4 + 1, hw[1] // 4 + 1))
        lab = np.kron(lab, np.ones((4, 4), np.int64))[:hw[0], :hw[1]]
        Image.fromarray(lab.astype(np.uint8)).save(
            os.path.join(ann_dir, stem + ".png"))
    Image.fromarray(np.zeros(hw + (3,), np.uint8)).save(
        os.path.join(img_dir, "ADE_val_unlabelled.jpg"))


def test_ade20k_val_matches_jax(tmp_path):
    from robseg_tpu.data.datasets import ADE20KSegmentation as JADE
    from robseg_tpu.utils import class_balance_weights as j_weights
    from robseg_torch.data import get_segmentation_dataset
    from robseg_torch.utils import class_balance_weights
    _write_ade_fixture(str(tmp_path))
    ds = get_segmentation_dataset("ade20k", root=str(tmp_path), split="val",
                                  crop_size=(32, 32))
    ref = JADE(str(tmp_path), split="val", mode="val", crop_size=32)
    assert len(ds) == len(ref) == 3 and ds.NUM_CLASS == 151
    for i in range(len(ds)):
        (xa, ya), (xb, yb) = ds[i], ref[i]
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
        assert ya.dtype == yb.dtype and np.array_equal(ya, yb)
        assert 0 <= ya.min() and ya.max() <= 150
    w = class_balance_weights("ade20k")
    assert w.shape == (151,) and np.array_equal(w, j_weights("ade20k"))


def _cfg(name, backbone, dataset="pascalvoc"):
    return {"MODEL": {"NAME": name, "BACKBONE": backbone},
            "EVAL": {"NAME": dataset, "BACKBONE": backbone}}


@pytest.mark.parametrize("name,backbone,kind", [
    ("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", "UperNet"),
    ("SegMenter", "vit_small_patch16_224", "SegMenter"),
    ("PSPNet", "ResNet-50", "PSPNet"),
    ("PSPNet_DDCAT", "ResNet-50", "PSPNetDDCAT"),
    ("DeepLabV3", "ResNet-50", "DeepLabV3"),
    ("DeepLabV3_DDCAT", "ResNet-50", "DeepLabV3DDCAT")])
def test_cli_builds_every_model(name, backbone, kind):
    m = infer.build_eval_model(_cfg(name, backbone), K, (473, 473))
    assert type(m).__name__.startswith(kind) and not m.training
    if name == "SegMenter":
        # the crop is the native grid: 473 // 16 = 29
        assert m.encoder.pos_embed.shape == (1, 29 * 29 + 1, 384)
    if name == "PSPNet":
        assert m.layer0[0].kernel_size == (3, 3)   # the deep-base stem


@pytest.mark.parametrize("name", ["DeepLabV3", "PSPNet_DDCAT",
                                  "DeepLabV3_DDCAT"])
def test_cli_refuses_pth_without_converter(name, tmp_path):
    path = tmp_path / "w.pth"
    torch.save({}, path)
    with pytest.raises(ValueError, match="no .pth loader"):
        infer.load_weights(torch.nn.Linear(1, 1), str(path), name)


def test_cli_loads_reference_pth(tmp_path):
    """A PSPNet and a Segmenter ``.pth`` (``module.``-prefixed, as the
    reference trainer saves them) load strictly; a Segmenter checkpoint
    of another grid gets its position embedding resampled."""
    for name in ("pspnet_7x7_stem", "segmenter"):
        src = _port(name)
        path = tmp_path / f"{name}.pth"
        torch.save({"module." + k: v for k, v in src.state_dict().items()},
                   path)
        dst = CASES[name][1]()
        model = "PSPNet" if name.startswith("pspnet") else "SegMenter"
        infer.load_weights(dst, str(path), model)
        for k, v in src.state_dict().items():
            assert torch.equal(dst.state_dict()[k], v), k
    wide = SegMenter(K, **dict(SEG, image_size=(48, 48)))
    infer.load_weights(wide, str(tmp_path / "segmenter.pth"), "SegMenter")
    from robseg_torch.models.vit import resize_pos_embed
    want = resize_pos_embed(src.encoder.pos_embed, None, (3, 3), 1)
    assert torch.equal(wide.encoder.pos_embed.data, want)


def test_drop_path_is_per_sample_stochastic_depth():
    """Identity in eval; in train each sample is dropped or scaled by
    1 / keep, as the JAX ``DropPath`` does (the port's models run eval)."""
    from robseg_torch.models.layers import DropPath
    dp = DropPath(0.5)
    x = torch.ones(64, 3, 4)
    assert torch.equal(dp.eval()(x), x)
    torch.manual_seed(0)
    y = dp.train()(x)
    per_sample = y.reshape(64, -1)
    assert bool(((per_sample == 0) | (per_sample == 2)).all())
    assert bool((per_sample == per_sample[:, :1]).all())
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64


@pytest.mark.parametrize("ignore_index", [0, 7, K - 1])
def test_wrappers_match_jax(ignore_index):
    """``normalize_input`` / ``normalize_model`` and ``mask_class`` /
    ``mask_logits`` on NCHW against the JAX (NHWC) ones; ``ModelBundle``
    with ``normalize`` runs the model on the normalised input."""
    from robseg_tpu.models import wrappers as jw
    from robseg_torch.models import wrappers as tw
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 5, 6)).astype(np.float32)
    lg = rng.normal(size=(2, K, 5, 6)).astype(np.float32)
    want = np.moveaxis(np.asarray(jw.normalize_input(
        jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    np.testing.assert_allclose(tw.normalize_input(torch.tensor(x)).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    want = np.moveaxis(np.asarray(jw.mask_class(
        jnp.asarray(np.moveaxis(lg, 1, -1)), ignore_index)), -1, 1)
    got = tw.mask_logits(lambda z: z, ignore_index)(torch.tensor(lg))
    assert got.shape == (2, K - 1, 5, 6) and np.array_equal(got.numpy(), want)
    bundle = ModelBundle(torch.nn.Identity(), normalize=True)
    out = tw.normalize_model(lambda z: z)(torch.tensor(x))
    assert torch.equal(bundle.logits_fn(torch.tensor(x)), out)
