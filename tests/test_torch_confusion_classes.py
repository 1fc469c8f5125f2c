"""The confusion histogram at any class count, on the CPU.

The port's ``confusion_matrix``, ``per_image_intersect_union`` and
``iou_acc_summary`` against the JAX package's functions of the same names
at K on both sides of the kernel's two forms (238: the largest K of the
shared form; 239, 300 and 847, ADE20K-full's classes: the global form),
summed and per image. Histograms, intersections and unions are exact; the
(mAcc, aAcc, mIoU) triple agrees to 1e-6, as JAX takes its means in
float32 in another order.

``plan``, the kernel's form and launch, is held to what the shared form
launched before the global form existed (K <= 238), and to the global
form above that; the wrapper refuses only ``num_classes < 1``. The kernels
themselves are held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robseg_tpu.ops import metrics as jm
from robseg_torch.kernels import confusion as cf
from robseg_torch.ops import metrics as tm

SHAPE = (2, 48, 40)
H100_SMS = 132


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
            assert cf.plan(k, rows, n, sms) == _launch_before(k, rows, n,
                                                              sms)
    # the SEA batch on the H100: K = 21, 16 copies (28 KB), two blocks a
    # SM; K = 151, one 91 KB copy, two a SM; K = 238, one 226,576-byte
    # copy, one a SM
    want = {1: (16, 64, 2), 21: (16, 28224, 2), 151: (1, 91204, 2),
            238: (1, 226576, 1)}[k]
    got = cf.plan(k, 1, 16 * 512 * 512, H100_SMS)
    assert (got["copies"], got["smem"], got["blocks_per_sm"]) == want
    assert got["grid"] == (H100_SMS * want[2], 1)


@pytest.mark.parametrize("k,width,copies", [
    (239, 239, 16), (847, 847, 16), (5000, 5000, 5), (40000, 28928, 1)])
def test_plan_takes_the_global_form_above_238(k, width, copies):
    """The diagonal in shared memory (per warp where it fits the two-block
    budget, at most 28,928 classes), two blocks a SM, the same grid rule."""
    for rows, n in ROWS:
        got = cf.plan(k, rows, n, H100_SMS)
        assert got["form"] == "global"
        assert (got["width"], got["copies"]) == (width, copies)
        assert got["smem"] == 4 * width * copies <= 113 * 1024
        assert got["blocks_per_sm"] == 2
        assert got["grid"] == (max(min(2 * H100_SMS // rows,
                                       (n // 8 + 511) // 512), 1), rows)


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
