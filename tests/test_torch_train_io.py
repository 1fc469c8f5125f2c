"""Checkpoints, PIR init, train data and the train CLI of the port, on the
CPU.

  * resume: 2 steps, a checkpoint, a fresh trainer restored from it and 2
    more steps are bit-identical to 4 straight steps (DropPath, dropout
    and the APGD random start drawn from the saved generator);
  * a JAX ``save_params_npz`` file (with its ``.stats.npz``) loads into
    the port through ``robseg_torch.infer.load_weights``, and the logits
    equal JAX's on it (atol = rtol = 1e-4, the eval logits' bound of
    tests/test_torch_models.py);
  * the PIR-init key maps on synthetic CvSt-ConvNeXt, ViT and ResNet-50
    state dicts equal JAX's converters followed by ``convert.from_jax``
    (exact; the resampled ViT position embedding within 1e-6);
  * ``train_sync_transform``, the ``IterationBasedLoader`` batches (also
    from a ``start_iter``) and VOC-aug on a ``scipy.io.savemat`` fixture
    exactly equal to the JAX package's;
  * ``python -m robseg_torch.train`` with ``DEVICE: cpu`` (run in the
    test's process through ``runpy``, UperNet cut small as in
    tests/test_torch_train_models.py): 64^2 crops, batch 2, one PGD
    iteration, ``--max_iters 2 --fused_attack``, then ``--resume`` to 3;
    and the refusals (no card for ``DEVICE: tpu``, ``--multihost``);
    ``TRAIN.DEVICE_AUG: true`` runs in tests/test_torch_device_aug.py,
    ``--precision`` and ``TRAIN.AMP`` in tests/test_torch_bf16_train.py.
"""

import os
import random
import re
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp
from PIL import Image

from robseg_tpu import data as jdata
from robseg_tpu.convert import torch2jax as t2j
from robseg_tpu.models import pspnet as jpsp
from robseg_tpu.models.segmenter import SegMenter as JSeg
from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_tpu.train.checkpoint import save_params_npz
from robseg_torch import data as tdata
from robseg_torch import infer
from robseg_torch.convert import (deeplab_state_dict_from_jax,
                                  pspnet_state_dict_from_jax,
                                  segmenter_state_dict_from_jax,
                                  upernet_state_dict_from_jax)
from robseg_torch.convert import pir
from robseg_torch.models import DeepLabV3, PSPNet, SegMenter, build_model
from robseg_torch.train import (AttackConfig, CheckpointManager, Trainer,
                                make_optimizer)
from robseg_torch.train.schedules import poly_lr
from test_torch_train_models import narrow_upernet, two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = dict(image_size=(32, 32), patch_size=16, n_layers=2, d_model=64,
           n_heads=2)


# -------------------------------------------------------------------- resume

def _seg_trainer(seed=0):
    torch.manual_seed(seed)
    m = SegMenter(5, **SEG)  # DropPath 0.1, decoder dropout 0.1
    opt = make_optimizer("sgd", m, poly_lr(1e-2, 10), weight_decay=1e-4)
    return Trainer(m, "SegMenter", opt,
                   AttackConfig(name="apgd", eps=4 / 255, n_iters=2),
                   generator=torch.Generator().manual_seed(7))


def test_resume_is_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    batches = [(torch.tensor(rng.random((2, 3, 32, 32)).astype(np.float32)),
                torch.tensor(rng.integers(0, 5, (2, 32, 32))))
               for _ in range(4)]
    straight = _seg_trainer()
    for x, y in batches:
        straight.train_step(x, y)
    first = _seg_trainer()
    for x, y in batches[:2]:
        first.train_step(x, y)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    mgr.save(first.step, first.state_dict())
    resumed = _seg_trainer(seed=1)  # other init: all of it comes back
    resumed.load_state_dict(CheckpointManager(str(tmp_path / "ckpts"))
                            .restore())
    assert resumed.step == 2
    for x, y in batches[2:]:
        resumed.train_step(x, y)
    want = straight.module.state_dict()
    for k, v in resumed.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not torch.equal(
        want["encoder.blocks.0.attn.qkv.weight"],
        _seg_trainer().module.state_dict()["encoder.blocks.0.attn.qkv.weight"])
    for s in (3, 4, 5):
        mgr.save(s, {"step": s})
    assert mgr.steps() == [4, 5] and mgr.restore()["step"] == 5


# ---------------------------------------------------- JAX .npz -> the port

def test_jax_npz_loads_into_the_port(tmp_path, monkeypatch):
    narrow_upernet(monkeypatch)  # in both packages: a short compile
    jm = JUN(backbone_variant="T_CVST", num_classes=21)
    # JAX variables from a seeded port init through the JAX converter,
    # BatchNorm statistics drawn at random
    torch.manual_seed(0)
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", 21)
    params, stats = t2j.convert_upernet(
        {k: v.numpy() for k, v in m.state_dict().items()}, "T_CVST")
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), stats)
    save_params_npz(str(tmp_path / "best_model.npz"), params)
    save_params_npz(str(tmp_path / "best_model.stats.npz"), stats)
    with torch.no_grad():  # every weight must come from the file
        for t in m.state_dict().values():
            t.zero_()
    infer.load_weights(m, str(tmp_path / "best_model.npz"),
                       "UperNetForSemanticSegmentation", "ConvNeXt-T_CVST")
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                             jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.tensor(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ PIR init

def _zeros_vars(jm, hw, **kw):
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1,) + hw + (3,)), **kw)
    z = lambda t: jax.tree.map(  # noqa: E731
        lambda s: np.zeros(s.shape, np.float32), dict(t))
    return z(v["params"]), z(v.get("batch_stats", {}))


def _assert_sd_equal(got, want, atol=0.0):
    for k, v in got.items():
        if atol:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=atol, rtol=0, err_msg=k)
        else:
            assert torch.equal(v, want[k]), k


def _random_sd(module, rng):
    return {k: torch.tensor(rng.normal(size=tuple(v.shape)).astype(
        np.float32)) for k, v in module.state_dict().items()
        if v.is_floating_point()}


def test_pir_convnext_cvst_matches_jax(tmp_path, monkeypatch):
    from robseg_tpu.models import convnext as jconvnext
    from robseg_torch.models import convnext as tconvnext
    for table in (jconvnext.CONVNEXT_SETTINGS, tconvnext.CONVNEXT_SETTINGS):
        # two blocks in stage 2, narrow stages (the CvSt stem is 48 -> 96)
        monkeypatch.setitem(table, "T_CVST", [[1, 1, 2, 1], [96, 32, 64, 128],
                                              64, table["T_CVST"][3]])
    rng = np.random.default_rng(1)
    port = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST",
                       21, fused=False)
    src = _random_sd(port, rng)
    # the CvSt pretraining layout, renamed from the port's backbone keys
    ren = [("backbone.downsample_layers.0.stem.", "stem.stem."),
           ("backbone.downsample_layers.", "stages.{}.downsample.")]
    ckpt = {"head.fc.weight": torch.zeros(3)}
    for k, v in src.items():
        if not k.startswith("backbone.") or k.startswith("backbone.norm"):
            continue
        if k.startswith(ren[0][0]):
            ckpt[ren[0][1] + k[len(ren[0][0]):]] = v
        elif k.startswith(ren[1][0]):
            layer, rest = k[len(ren[1][0]):].split(".", 1)
            ckpt[f"stages.{layer}.downsample.{rest}"] = v
        else:
            j, b, rest = k[len("backbone.stages."):].split(".", 2)
            rest = {"dwconv": "conv_dw", "pwconv1": "mlp.fc1",
                    "pwconv2": "mlp.fc2"}.get(rest.split(".")[0],
                                              rest.split(".")[0]) + \
                (rest[rest.index("."):] if "." in rest else "")
            ckpt[f"stages.{j}.blocks.{b}.{rest}"] = v
    params, stats = _zeros_vars(JUN(backbone_variant="T_CVST",
                                    num_classes=21), (32, 32))
    bb = t2j.convert_convnext_backbone({k: v.numpy() for k, v in
                                        ckpt.items()}, "T_CVST",
                                       cvst_ckpt_layout=True)
    params["backbone"].update(bb)
    want = upernet_state_dict_from_jax(params, stats, "T_CVST")
    got = pir.convnext_cvst_backbone(ckpt, "T_CVST")
    assert len(got) == sum(k.startswith("backbone.")
                           and not k.startswith("backbone.norm")
                           for k in want)
    _assert_sd_equal(got, want)
    # load_pir: a wrapped checkpoint file into the model
    torch.save({"model": {"module." + k: v for k, v in ckpt.items()}},
               tmp_path / "cvst.pth")
    n = pir.load_pir(port, "UperNetForSemanticSegmentation",
                     "ConvNeXt-T_CVST", str(tmp_path / "cvst.pth"), False)
    assert n == len(got)
    _assert_sd_equal(got, port.state_dict())


def test_pir_vit_matches_jax():
    rng = np.random.default_rng(2)
    port = SegMenter(21, **SEG)  # native grid 2 x 2
    enc = {k[len("encoder."):]: v for k, v in _random_sd(port, rng).items()
           if k.startswith("encoder.")}
    enc["pos_embed"] = torch.tensor(rng.normal(size=(1, 1 + 24 * 24, 64))
                                    .astype(np.float32))  # a 384 grid
    enc["head.weight"] = torch.zeros(2)
    params, _ = _zeros_vars(JSeg(n_cls=21, **SEG), (32, 32))
    params["encoder"] = t2j.convert_vit_encoder(
        {k: v.numpy() for k, v in enc.items()}, n_layers=2,
        target_grid=(2, 2))
    want = segmenter_state_dict_from_jax(params, 2)
    got = pir.pir_state_dict("SegMenter", "", port, enc, False)
    assert got["encoder.pos_embed"].shape == (1, 5, 64)
    assert set(got) == {k for k in want if k.startswith("encoder.")}
    _assert_sd_equal({k: v for k, v in got.items() if k != "encoder.pos_embed"},
                     want)
    _assert_sd_equal({"encoder.pos_embed": got["encoder.pos_embed"]}, want,
                     atol=1e-6)


@pytest.mark.parametrize("deep_base", [False, True])
def test_pir_resnet_matches_jax(deep_base):
    rng = np.random.default_rng(3)
    port = PSPNet(classes=21, deep_base=deep_base)
    src = _random_sd(port, rng)
    stem = {"layer0.0": "conv1", "layer0.1": "bn1", "layer0.3": "conv2",
            "layer0.4": "bn2", "layer0.6": "conv3", "layer0.7": "bn3"}
    ckpt = {"fc.weight": torch.zeros(2)}
    for k, v in src.items():
        head, rest = k.rsplit(".", 1) if k.count(".") == 2 else (None, None)
        if head in stem:
            ckpt[f"{stem[head]}.{rest}"] = v
        elif k.startswith("layer") and not k.startswith("layer0"):
            ckpt[k] = v
    np_ckpt = {k: v.numpy() for k, v in ckpt.items()}
    bbp, bbs = t2j.convert_resnet_backbone(np_ckpt, deep_base=deep_base)
    params, stats = _zeros_vars(jpsp.PSPNet(classes=21, deep_base=deep_base),
                                (33, 33))
    params["backbone"].update(bbp)
    stats["backbone"].update(bbs)
    want = pspnet_state_dict_from_jax(params, stats, deep_base)
    got = pir.pir_state_dict("PSPNet", "ResNet-50", port, ckpt, deep_base)
    assert all(k.startswith("layer") for k in got)
    assert len(got) == sum(k.startswith("layer")
                           and not k.endswith("num_batches_tracked")
                           for k in want)
    _assert_sd_equal(got, want)
    if not deep_base:  # the DeepLab / DDCAT layout: backbone.*
        params, stats = _zeros_vars(jpsp.DeepLabV3(classes=21,
                                                   deep_base=False), (33, 33))
        params["backbone"].update(bbp)
        stats["backbone"].update(bbs)
        want = deeplab_state_dict_from_jax(params, stats, deep_base=False)
        got = pir.pir_state_dict("DeepLabV3", "", DeepLabV3(deep_base=False),
                                 ckpt, False)
        assert all(k.startswith("backbone.") for k in got)
        _assert_sd_equal(got, want)


# ---------------------------------------------------------------- train data

def test_train_sync_transform_matches_jax():
    from robseg_tpu.data.transforms import train_sync_transform as j_tr
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(((60, 90), (120, 70), (40, 40))):
        img = Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
        mask = Image.fromarray(rng.integers(0, 21, (h, w)).astype(np.uint8))
        for crop, base in ((48, 64), (96, 64)):
            a = tdata.train_sync_transform(img, mask, base_size=base,
                                           crop_size=crop,
                                           rng=random.Random(i))
            b = j_tr(img, mask, base_size=base, crop_size=crop,
                     rng=random.Random(i))
            for u, v in zip(a, b):
                assert u.dtype == v.dtype and np.array_equal(u, v)


def _fake_voc(root, n_train=5, n_val=2, hw=(60, 80)):
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    idx = 0
    for split, n in (("train", n_train), ("val", n_val)):
        names = []
        for _ in range(n):
            rng = np.random.default_rng(idx)
            name = f"img{idx:04d}"
            Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)
                            ).save(os.path.join(base, "JPEGImages",
                                                name + ".jpg"))
            m = rng.integers(0, 21, hw).astype(np.uint8)
            m[0, :4] = 255
            Image.fromarray(m).save(os.path.join(base, "SegmentationClass",
                                                 name + ".png"))
            names.append(name)
            idx += 1
        with open(os.path.join(base, "ImageSets/Segmentation",
                               f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


@pytest.mark.parametrize("start_iter", [0, 3])
def test_iteration_loader_matches_jax(tmp_path, start_iter):
    root = _fake_voc(str(tmp_path))
    kw = dict(root=root, split="train", mode="train", base_size=48,
              crop_size=40, seed=3)
    jl = jdata.IterationBasedLoader(
        jdata.get_segmentation_dataset("pascalvoc", **kw), num_shards=1,
        batch_per_shard=2, max_iters=6, seed=3, start_iter=start_iter)
    tl = tdata.IterationBasedLoader(
        tdata.get_segmentation_dataset("pascalvoc", **kw), batch_size=2,
        max_iters=6, seed=3, start_iter=start_iter)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == 6 - start_iter
    for (ti, tm), (ji, jmsk) in zip(got, want):
        assert ti.dtype == np.float32 and tm.dtype == np.int64
        assert np.array_equal(ti, np.moveaxis(ji, -1, 1))
        assert np.array_equal(tm, jmsk)
    assert list(tdata.prefetch(iter(range(5)), depth=2)) == list(range(5))


def test_voc_aug_mat_matches_jax(tmp_path):
    import scipy.io as sio
    base = tmp_path / "VOCaug/dataset"
    (base / "img").mkdir(parents=True)
    (base / "cls").mkdir(parents=True)
    names = []
    for i in range(3):
        name = f"2008_{i:06d}"
        rng = np.random.default_rng(i)
        Image.fromarray((rng.random((60, 80, 3)) * 255).astype(np.uint8)
                        ).save(base / "img" / f"{name}.jpg")
        seg = rng.integers(0, 21, (60, 80)).astype(np.uint8)
        seg[:2, :2] = 255
        sio.savemat(str(base / "cls" / f"{name}.mat"),
                    {"GTcls": {"Segmentation": seg}})
        names.append(name)
    (base / "trainval.txt").write_text("\n".join(names) + "\n")
    (base / "val.txt").write_text(names[0] + "\n")
    for split, mode in (("train", "train"), ("val", "val")):
        kw = dict(split=split, mode=mode, base_size=64, crop_size=48)
        t = tdata.get_segmentation_dataset("pascalaug", root=str(tmp_path),
                                           **kw)
        j = jdata.VOCAugSegmentation(str(tmp_path), **kw)
        assert len(t) == len(j)
        for i in range(len(t)):
            for u, v in zip(t[i], j[i]):
                assert u.dtype == v.dtype and np.array_equal(u, v)


def test_synthetic_dataset_matches_jax():
    kw = dict(num_classes=7, length=3, image_hw=(40, 56), crop_size=32)
    t, j = tdata.SyntheticSegmentation(**kw), jdata.SyntheticSegmentation(**kw)
    for i in range(3):
        for u, v in zip(t[i], j[i]):
            assert np.array_equal(u, v)


# ------------------------------------------------------------------ the CLI

def _cfg(tmp_path, **train):
    with open(os.path.join(REPO, "configs", "pascalvoc_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DEVICE"] = "cpu"
    cfg["SAVE_DIR"] = str(tmp_path / "out")
    cfg["DATASET"].update(NAME="pascalvoc",
                          ROOT=_fake_voc(str(tmp_path / "voc"), 4, 2))
    cfg["TRAIN"].update(BASE_SIZE=64, IMAGE_SIZE=[64, 64], BATCH_SIZE=2,
                        N_ITERS=1, EVAL_FREQ=1, EVAL_BATCHES=1, **train)
    cfg["EVAL"].update(IMAGE_SIZE=[64, 64], BASE_SIZE=64)
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _train(monkeypatch, capsys, *args):
    """``python -m robseg_torch.train *args``, run in this process as
    ``-m`` runs it (``runpy``), so the test's narrow UperNet applies; its
    standard output. The CLI's TF32 flags are restored after."""
    monkeypatch.setattr(sys, "argv", ["robseg_torch.train", *args])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        runpy.run_module("robseg_torch.train", run_name="__main__",
                         alter_sys=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return capsys.readouterr().out


def test_train_cli_on_cpu_trains_and_resumes(tmp_path, monkeypatch, capsys):
    narrow_upernet(monkeypatch)
    cfg = _cfg(tmp_path)
    run = str(tmp_path / "run")
    out = _train(monkeypatch, capsys, "--cfg", cfg, "--max_iters", "2",
                 "--fused_attack", "--run_dir", run)
    # 4 train images at batch 2: a log line every iteration, an eval and a
    # checkpoint at the end of each epoch (iteration 2)
    losses = [float(v) for v in re.findall(r"Loss: ([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "Epoch [1] val mIoU=" in out and "full mIoU" in out
    assert "Reloaded best checkpoint" in out or "Best mIoU" in out
    for name in ("final_model.pth", "best.json", "train_log"):
        assert os.path.exists(os.path.join(run, name)), name
    assert os.listdir(os.path.join(run, "ckpts")) == ["ckpt_2.pt"]
    # the weights load strictly into the SEA CLI's (fused) model
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", 21)
    infer.load_weights(m, os.path.join(run, "final_model.pth"))
    out2 = _train(monkeypatch, capsys, "--cfg", cfg, "--max_iters", "3",
                  "--resume", "--run_dir", run, "--fused_attack")
    assert "Resumed from step 2" in out2 and "Restored best-so-far" in out2
    assert len(re.findall(r"Loss: ", out2)) == 1
    assert sorted(os.listdir(os.path.join(run, "ckpts"))) == [
        "ckpt_2.pt", "ckpt_3.pt"]


def test_train_cli_refusals(tmp_path, monkeypatch):
    """``--multihost`` without torchrun's rendezvous environment is a
    parser error (with it, it parses; the data-parallel runs:
    tests/test_torch_parallel.py) and ``DEVICE: tpu`` without a card
    raises; ``--precision bf16`` and ``TRAIN.AMP`` train (their runs:
    tests/test_torch_bf16_train.py)."""
    from robseg_torch.train import __main__ as cli
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):
        cli.parse_args(["--cfg", "x.yaml", "--multihost"])
    with monkeypatch.context() as mp:
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
            mp.setenv(k, v)
        assert cli.parse_args(["--cfg", "x.yaml", "--multihost"]).multihost
    assert cli.parse_args(["--cfg", "x.yaml", "--precision",
                           "bf16"]).precision == "bf16"
    cfg = _cfg(tmp_path)
    with open(cfg) as f:
        c = yaml.safe_load(f)
    c["DEVICE"] = "tpu"
    with open(cfg, "w") as f:
        yaml.safe_dump(c, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no"):
            cli.main(["--cfg", cfg])
