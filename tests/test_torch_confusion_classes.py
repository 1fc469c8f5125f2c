"""The confusion histogram at any class count, on the CPU.

The port's ``confusion_matrix``, ``per_image_intersect_union`` and
``iou_acc_summary`` against the JAX package's functions of the same names
at K on both sides of the shared form's limit (238: its largest K; 239,
300 and 847, ADE20K-full's classes), summed and per image. Histograms,
intersections and unions are exact; the (mAcc, aAcc, mIoU) triple agrees
to 1e-6, as JAX takes its means in float32 in another order.

``plan``, the kernel's form and launch, is held to what the shared form
launched before the global form existed (K <= 238), to the global form
above that, to its grid rule on an H100's SM count and L2 and on another
L2, and its constants to the CUDA source's; the wrapper refuses only
``num_classes < 1``. The kernels themselves are held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robseg_tpu.ops import metrics as jm
from robseg_torch.kernels import confusion as cf
from robseg_torch.ops import metrics as tm

SHAPE = (2, 48, 40)
# an NVIDIA H100 80GB HBM3 as torch.cuda.get_device_properties reports it:
# its SMs and its L2 bytes, plan's card arguments
H100 = (132, 50 << 20)
H100_SMS = H100[0]


def _labels(k, seed):
    """Targets in [0, K) with 5% ignored (-1); predictions equal to the
    target on about half of the pixels, and -1, K or K + 2 (counted
    nowhere) on about 6%."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, k, SHAPE)
    p = np.where(rng.random(SHAPE) < 0.5, t, rng.integers(0, k, SHAPE))
    off = rng.random(SHAPE) < 0.06
    p[off] = rng.choice([-1, k, k + 2], int(off.sum()))
    t[rng.random(SHAPE) < 0.05] = -1
    return p, t


@pytest.mark.parametrize("per_image", [False, True],
                         ids=["summed", "per_image"])
@pytest.mark.parametrize("k", [238, 239, 300, 847])
def test_metrics_match_jax_at_any_class_count(k, per_image):
    p, t = _labels(k, seed=k)
    pj, tj = jnp.asarray(p.astype(np.int32)), jnp.asarray(t.astype(np.int32))
    pt, tt = torch.tensor(p), torch.tensor(t)
    if per_image:
        want = np.asarray(jax.vmap(lambda a, b: jm._hist_matmul(
            a, b, b != -1, k))(pj, tj))
        got = cf.confusion_hist(pt, tt, num_classes=k, per_image=True)
        assert np.array_equal(got.numpy(), want)
        i_w, u_w = jm.per_image_intersect_union(pj, tj, num_classes=k)
        i_g, u_g = tm.per_image_intersect_union(pt, tt, num_classes=k)
        assert np.array_equal(i_g.numpy(), np.asarray(i_w))
        assert np.array_equal(u_g.numpy(), np.asarray(u_w))
        assert float(i_g.sum()) > 0
    else:
        want = np.asarray(jm.confusion_matrix(pj, tj, num_classes=k))
        got = tm.confusion_matrix(pt, tt, num_classes=k)
        assert np.array_equal(got.numpy(), want)
        assert float(np.trace(want)) > 0 and float(want.sum()) > np.trace(
            want)
        for a, b in zip(tm.iou_acc_summary(pt, tt, num_classes=k),
                        jm.iou_acc_summary(pj, tj, num_classes=k)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def _launch_before(k, rows, n, sms):
    """The shared form's launch as ``launch`` in csrc/confusion.cu computed
    it in C, before ``plan`` took it over: per-warp copies of the K x K
    histogram in a 113 KB budget, two blocks a SM if they fit, the resident
    blocks split over the rows, capped at one 8-pixel group a thread."""
    kk = k * k
    copies = min(max(113 * 1024 // (kk * 4), 1), 16)
    smem = copies * kk * 4
    per_sm = 2 if smem <= 113 * 1024 else 1
    gx = max(min(sms * per_sm // rows, (n // 8 + 511) // 512), 1)
    return {"form": "shared", "width": kk, "copies": copies, "smem": smem,
            "blocks_per_sm": per_sm, "grid": (gx, rows)}


# (rows, pixels a row): the SEA batch summed and per image, the VOC crop's
# odd rows per image, a map smaller than one block's groups, 2^24 pixels
ROWS = [(1, 16 * 512 * 512), (16, 512 * 512), (3, 473 * 473), (2, 35),
        (1, 64 * 512 * 512)]


@pytest.mark.parametrize("k", [1, 21, 151, 238])
def test_plan_keeps_the_shared_form_launch(k):
    for rows, n in ROWS:
        for sms in (H100_SMS, 114):
            for l2 in (H100[1], 40 << 20):
                assert cf.plan(k, rows, n, sms, l2) == _launch_before(
                    k, rows, n, sms)
    # the SEA batch on the H100: K = 21, 16 copies (28 KB), two blocks a
    # SM; K = 151, one 91 KB copy, two a SM; K = 238, one 226,576-byte
    # copy, one a SM
    got = cf.plan(k, 1, 16 * 512 * 512, *H100)
    want = {1: (16, 2), 21: (16, 2), 151: (1, 2), 238: (1, 1)}[k]
    assert (got["copies"], got["blocks_per_sm"]) == want
    assert got["grid"] == (H100_SMS * want[1], 1)


def _global_grid(k, rows, n, sms=H100_SMS, l2=H100[1]):
    """The global form's grid: the card's resident blocks (two a SM) over
    the rows, or over half of them where their 4-byte outputs pass 5/8 of
    the L2, capped at one 8-pixel group a thread."""
    live = max(1, rows // 2) if 4 * k * k * rows > l2 * 5 / 8 else rows
    return (max(min(2 * sms // live, (n // 8 + 511) // 512), 1), rows)


@pytest.mark.parametrize("k,width,copies", [
    (239, 239, 16), (300, 300, 16), (459, 459, 16), (673, 673, 16),
    (847, 847, 16), (5000, 5000, 5), (40000, 28928, 1)])
def test_plan_takes_the_global_form_above_238(k, width, copies):
    """The diagonal in shared memory (per warp where it fits the two-block
    budget, at most 28,928 classes), two blocks a SM, the resident blocks
    over the rows, or over half of them past 5/8 of the L2 of outputs."""
    for rows, n in ROWS:
        for sms, l2 in (H100, (114, 40 << 20)):
            got = cf.plan(k, rows, n, sms, l2)
            assert got == {"form": "global", "width": width,
                           "copies": copies, "smem": 4 * width * copies,
                           "blocks_per_sm": 2,
                           "grid": _global_grid(k, rows, n, sms, l2)}
            assert got["smem"] <= 113 * 1024


# (K, rows, pixels a row, the grid's blocks a row) on the H100: 264
# resident blocks over the rows, at most one 8-pixel group a thread; per
# image at the SEA batch half the images at once from K = 716, whose 16
# outputs (32.8 MB) pass 5/8 of the 50 MiB L2 (K = 715: 32.7 MB); two rows
# from K = 2024 (2000: 32.0 MB), one row never halved
@pytest.mark.parametrize("k,rows,n,blocks", [
    (239, 16, 512 * 512, 16), (300, 16, 512 * 512, 16),
    (459, 16, 512 * 512, 16), (673, 16, 512 * 512, 16),
    (715, 16, 512 * 512, 16), (716, 16, 512 * 512, 33),
    (847, 16, 512 * 512, 33), (847, 8, 512 * 512, 33),
    (847, 7, 512 * 512, 37), (847, 3, 473 * 473, 55),
    (2000, 2, 4 * 512 * 512, 132), (2100, 2, 4 * 512 * 512, 256),
    (3000, 1, 16 * 512 * 512, 264), (239, 1, 16 * 512 * 512, 264),
    (847, 1, 16 * 512 * 512, 264), (847, 64, 512 * 512, 8)])
def test_plan_on_the_h100(k, rows, n, blocks):
    assert cf.plan(k, rows, n, *H100)["grid"] == (blocks, rows)


@pytest.mark.parametrize("k,halved", [(673, True), (459, False),
                                      (847, True)])
def test_plan_follows_the_cards_l2(k, halved):
    """On a card with 40 MiB of L2 (5/8 of it: 26.2 MB) 16 images at K =
    673 (29.0 MB of outputs) are counted half at once; K = 459 (13.5 MB)
    all at once. 114 SMs: 228 resident blocks."""
    got = cf.plan(k, 16, 512 * 512, 114, 40 << 20)
    assert got["grid"] == ((28 if halved else 14), 16)


@pytest.mark.parametrize("name,value", [
    ("kThreads", cf.THREADS), ("kWarps", cf.WARPS), ("kRun", cf.RUN),
    ("kSmemTwoBlocks", cf.SMEM_TWO_BLOCKS), ("kShared", cf.FORMS["shared"]),
    ("kGlobal", cf.FORMS["global"]), ("kSmemMax", 227 * 1024)])
def test_constants_are_the_kernels(name, value):
    """plan's copies of csrc/confusion.cu's constants are the source's."""
    src = (Path(cf.__file__).parents[1] / "csrc" / "confusion.cu").read_text()
    got = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert got, name
    assert eval(got[1], {"kThreads": cf.THREADS}) == value


@pytest.mark.parametrize("k", [0, -1, 239, 847, 100000])
def test_only_nonpositive_class_counts_are_refused(k):
    """The wrapper refuses K < 1 for its value; any K >= 1 passes the
    class check and is refused here only because the tensors lie on the
    CPU (the kernel takes CUDA tensors)."""
    assert not hasattr(cf, "MAX_CLASSES")
    p = torch.zeros((1, 4, 4), dtype=torch.int64)
    why = "num_classes must be at least 1" if k < 1 else "not CUDA"
    with pytest.raises(ValueError, match=why):
        cf.confusion_matrix_cuda(p, p, num_classes=k)
