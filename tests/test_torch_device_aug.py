"""``TRAIN.DEVICE_AUG`` and the ADE20K train split against the JAX package,
and the train CLI with ``DEVICE_AUG: true`` on the CPU.

  * ``load_raw_batch`` (numpy and PIL, copied): bit-equal to JAX's, with
    images above and below the buffer's edge;
  * ``apply_augment`` given the draws JAX's ``_augment_one`` reads from the
    same key (``jax.random.split`` into six, read here): images within
    atol 1e-5 (float32 bilinear reads and blur sums in another order),
    masks exactly equal;
  * ``_blur`` (per-image radius) within 1e-5 and ``apply_color_jitter``
    with JAX's ``color_jitter`` factors within 1e-5;
  * ``augment_batch`` with the port's own draws (another stream than
    JAX's): shapes, dtypes, values in [0, 1], labels from the buffer;
  * the ADE20K train file list equal to JAX's on a fake tree;
  * ``python -m robseg_torch.train`` with ``DEVICE_AUG: true``, in this
    process as tests/test_torch_train_io.py runs it (UperNet cut small,
    64^2 crops from 128^2 buffers), for 2 iterations, then ``--resume``
    to 3. It replaces the refusal ``DEVICE_AUG: true`` met before this
    slice.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from robseg_tpu.data import device_transforms as jdt
from robseg_tpu.data.datasets import ADE20KSegmentation as JADE
from robseg_torch.data import device_transforms as tdt
from robseg_torch.data import get_segmentation_dataset
from test_torch_train_io import _cfg, _fake_voc, _train
from test_torch_train_models import narrow_upernet, two_threads  # noqa: F401

BASE, CROP = 48, 40


def _buffers(rng, b=4, hs=96, ws=96):
    imgs = rng.random((b, hs, ws, 3)).astype(np.float32)
    masks = rng.integers(0, 21, (b, hs, ws)).astype(np.int32)
    valid = np.array([[96, 80], [70, 96], [50, 60], [96, 96]],
                     np.int32)[:b]
    for i, (h, w) in enumerate(valid):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
        masks[i, h:] = 0
        masks[i, :, w:] = 0
    return imgs, masks, valid


def _jax_draws(key, n):
    """The six draws ``_augment_one`` makes from each image's key."""
    out = []
    for k in jax.random.split(key, n):
        r_flip, r_scale, r_bp, r_br, r_cx, r_cy = jax.random.split(k, 6)
        out.append(dict(
            short=float(jax.random.uniform(r_scale, (), minval=0.5 * BASE,
                                           maxval=2.0 * BASE)),
            u_y=float(jax.random.uniform(r_cy, ())),
            u_x=float(jax.random.uniform(r_cx, ())),
            flip=bool(jax.random.bernoulli(r_flip, 0.5)),
            blur=bool(jax.random.bernoulli(r_bp, 0.5)),
            radius=float(jax.random.uniform(r_br, ()))))
    return {k: torch.tensor([d[k] for d in out],
                            dtype=torch.bool if k in ("flip", "blur")
                            else torch.float32) for k in out[0]}


def _nchw(a):
    return torch.tensor(np.moveaxis(a, -1, 1)).contiguous()


@pytest.mark.parametrize("seed", [3, 11, 12])
def test_apply_matches_jax_augment_one(seed):
    imgs, masks, valid = _buffers(np.random.default_rng(seed))
    key = jax.random.PRNGKey(seed)
    params = _jax_draws(key, imgs.shape[0])
    ji, jm = jdt.augment_batch(jnp.asarray(imgs), jnp.asarray(masks),
                               jnp.asarray(valid), key, base_size=BASE,
                               crop_size=CROP)
    ti, tm = tdt.apply_augment(_nchw(imgs), torch.tensor(masks),
                               torch.tensor(valid), params, crop_size=CROP)
    assert ti.shape == (4, 3, CROP, CROP) and ti.dtype == torch.float32
    assert tm.shape == (4, CROP, CROP) and tm.dtype == torch.int64
    np.testing.assert_allclose(ti.numpy(), np.moveaxis(np.asarray(ji), -1, 1),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_blur_and_color_jitter_match_jax(rng):
    img = rng.random((2, 20, 24, 3)).astype(np.float32)
    radius = np.array([0.0, 0.7], np.float32)  # 0: sigma clamps to 1e-3
    got = tdt._blur(_nchw(img), torch.tensor(radius)).numpy()
    for i in range(2):
        want = np.asarray(jdt._blur(jnp.asarray(img[i]),
                                    jnp.asarray(radius[i])))
        np.testing.assert_allclose(got[i], np.moveaxis(want, -1, 0),
                                   rtol=0, atol=1e-5)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jdt.color_jitter(jnp.asarray(img[0]), key))
    rb, rc, rs = jax.random.split(key, 3)
    factors = [float(jax.random.uniform(r, (), minval=0.5, maxval=1.5))
               for r in (rb, rc, rs)]
    got = tdt.apply_color_jitter(_nchw(img[:1])[0], factors).numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0), rtol=0,
                               atol=1e-5)
    out = tdt.color_jitter(_nchw(img), torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, 20, 24) and 0 <= out.min() <= out.max() <= 1


def test_augment_batch_own_draws(rng):
    imgs, masks, valid = _buffers(rng)
    gen = torch.Generator().manual_seed(0)
    ti, tm = tdt.augment_batch(_nchw(imgs), torch.tensor(masks),
                               torch.tensor(valid), gen, base_size=BASE,
                               crop_size=CROP)
    assert ti.shape == (4, 3, CROP, CROP) and tm.shape == (4, CROP, CROP)
    assert float(ti.min()) >= 0 and float(ti.max()) <= 1
    assert set(np.unique(tm.numpy())) <= set(np.unique(masks))
    again = tdt.augment_batch(_nchw(imgs), torch.tensor(masks),
                              torch.tensor(valid),
                              torch.Generator().manual_seed(0),
                              base_size=BASE, crop_size=CROP)
    assert torch.equal(again[0], ti) and torch.equal(again[1], tm)


def _write_ade(root, n=4):
    base = os.path.join(root, "ADEChallengeData2016")
    for split, tag in (("training", "train"), ("validation", "val")):
        img_dir = os.path.join(base, "images", split)
        ann_dir = os.path.join(base, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(n):
            rng = np.random.default_rng(i)
            hw = (40 + 30 * i, 52 + 20 * i)  # one above a 96 buffer
            stem = f"ADE_{tag}_{i:08d}"
            Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)
                            ).save(os.path.join(img_dir, stem + ".jpg"))
            Image.fromarray(rng.integers(0, 151, hw).astype(np.uint8)).save(
                os.path.join(ann_dir, stem + ".png"))
        # an image without annotation and a stray file are skipped
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
            os.path.join(img_dir, f"ADE_{tag}_unlabelled.jpg"))
        open(os.path.join(img_dir, "notes.txt"), "w").close()


def test_ade20k_train_split_and_raw_batch_match_jax(tmp_path):
    _write_ade(str(tmp_path))
    t = get_segmentation_dataset("ade20k", root=str(tmp_path),
                                 split="train", mode="train", base_size=48,
                                 crop_size=32)
    j = JADE(str(tmp_path), split="train", mode="train", base_size=48,
             crop_size=32)
    assert t.images == j.images and t.masks == j.masks and len(t) == 4
    assert all("/images/training/" in p for p in t.images)
    for i in (0, 3):  # host train transform, same per-sample seeding
        for u, v in zip(t[i], j[i]):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    idx = np.array([3, 0, 2])
    for got, want in zip(
            tdt.load_raw_batch(t, idx, buffer_hw=(96, 96), max_edge=96),
            jdt.load_raw_batch(j, idx, buffer_hw=(96, 96), max_edge=96)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_train_cli_device_aug_on_cpu(tmp_path, monkeypatch, capsys):
    narrow_upernet(monkeypatch)
    cfg = _cfg(tmp_path, DEVICE_AUG=True)
    run = str(tmp_path / "run")
    out = _train(monkeypatch, capsys, "--cfg", cfg, "--max_iters", "2",
                 "--fused_attack", "--run_dir", run)
    losses = [float(v) for v in re.findall(r"Loss: ([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "Epoch [1] val mIoU=" in out and "full mIoU" in out
    assert os.listdir(os.path.join(run, "ckpts")) == ["ckpt_2.pt"]
    out2 = _train(monkeypatch, capsys, "--cfg", cfg, "--max_iters", "3",
                  "--resume", "--run_dir", run, "--fused_attack")
    assert "Resumed from step 2" in out2
    assert len(re.findall(r"Loss: ", out2)) == 1


def test_raw_batches_follow_the_sampler(tmp_path):
    """The CLI's raw loader: the ``ShardedEpochSampler``'s batches in
    order, across an epoch boundary and from a resumed iteration."""
    from robseg_torch.data import ShardedEpochSampler
    from robseg_torch.train.__main__ import raw_batches
    root = _fake_voc(str(tmp_path / "voc"), 5, 1)
    ds = get_segmentation_dataset("pascalvoc", root=root, split="train",
                                  mode="train", base_size=32, crop_size=32)
    sampler = ShardedEpochSampler(len(ds), 1, seed=4)
    want = [idx for e in range(3)
            for idx in sampler.global_batch_indices(e, 2)]  # 2 an epoch
    for start in (0, 3):
        got = list(raw_batches(ds, batch_size=2, max_iters=5, seed=4,
                               start_iter=start, buffer=64))
        assert len(got) == 5 - start
        for (imgs, masks, valid), idx in zip(got, want[start:5]):
            ref = tdt.load_raw_batch(ds, idx, buffer_hw=(64, 64),
                                     max_edge=64)
            assert all(np.array_equal(a, b)
                       for a, b in zip((imgs, masks, valid), ref))
