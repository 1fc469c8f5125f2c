"""robseg_torch.ops against robseg_tpu.ops on the same numpy inputs.

Tolerances: losses rtol 1e-5 / atol 1e-6 (float32 log-softmax in two
frameworks); projections and metrics exact; resizes atol 1e-5 (the same
float32 interpolation matrices, applied by matmuls that sum in another
order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from robseg_tpu.ops import losses as jl
from robseg_tpu.ops import metrics as jm
from robseg_tpu.ops.projections import project_linf as j_project_linf
from robseg_tpu.ops.resize import adaptive_avg_pool as j_pool
from robseg_tpu.ops.resize import resize_bilinear as j_resize
from robseg_torch.ops import losses as tl
from robseg_torch.ops import metrics as tm
from robseg_torch.ops.projections import project_linf
from robseg_torch.ops.resize import adaptive_avg_pool, resize_bilinear
from robseg_torch.utils import VOC_WTS

K = 21
SHAPE = (2, K, 24, 20)


def _nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def _logits_labels(rng, saturate: bool):
    lg = rng.normal(size=SHAPE).astype(np.float32) * 3.0
    y = rng.integers(0, K, (2, 24, 20))
    y[0, :3, :5] = -1
    y[1, 10:, 7] = -1
    if saturate:
        # softmax saturates to exact zeros: the _TINY clamp path of js-avg
        lg[:, 0, :6] += 200.0
        lg[:, 4, 6:12] -= 200.0
    return lg, y


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("name", ["ce", "ce-avg", "mask-ce-avg",
                                  "mask-ce-bal", "js-avg"])
def test_criteria_match(rng, name, saturate):
    lg, y = _logits_labels(rng, saturate)
    # make some pixels correct so the Mask-CE masks are non-trivial
    am = lg.argmax(1)
    y = np.where(rng.random(y.shape) < 0.4, am, y)
    y[0, :3, :5] = -1
    w = VOC_WTS
    want = np.asarray(jl.ATTACK_CRITERIA[name](
        jnp.asarray(_nhwc(lg)), jnp.asarray(y.astype(np.int32)),
        jnp.asarray(w)))
    lg_t = torch.tensor(lg, requires_grad=True)
    got = tl.ATTACK_CRITERIA[name](lg_t, torch.tensor(y), torch.tensor(w))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    assert np.all(got.detach().numpy()[y == -1] == 0.0)
    mask = torch.tensor((y != -1).astype(np.float32))
    img = tl.pixel_to_img_loss(got, mask)
    want_img = np.asarray(jl.pixel_to_img_loss(
        jnp.asarray(want), jnp.asarray(y != -1, jnp.float32)))
    np.testing.assert_allclose(img.detach().numpy(), want_img, rtol=1e-5,
                               atol=1e-6)
    img.sum().backward()
    assert torch.isfinite(lg_t.grad).all()


def test_mask_is_detached(rng):
    lg, y = _logits_labels(rng, False)
    y = lg.argmax(1)
    lg_t = torch.tensor(lg, requires_grad=True)
    loss = tl.masked_cross_entropy(lg_t, torch.tensor(y)).sum()
    (g,) = torch.autograd.grad(loss, lg_t)
    ce = tl.cross_entropy_pixelwise(lg_t, torch.tensor(y)).sum()
    (g_ce,) = torch.autograd.grad(ce, lg_t)
    # every pixel is correct: the mask is all ones and contributes nothing
    torch.testing.assert_close(g, g_ce)


def test_project_linf_exact(rng):
    x = rng.random((2, 3, 9, 7)).astype(np.float32)
    z = (x + rng.normal(size=x.shape).astype(np.float32) * 0.1)
    eps = np.float32(8 / 255)
    want = np.asarray(j_project_linf(jnp.asarray(z), jnp.asarray(x), eps))
    got = project_linf(torch.tensor(z), torch.tensor(x), float(eps))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw_in,hw_out", [((15, 15), (6, 6)),
                                          ((30, 30), (60, 60)),
                                          ((119, 119), (473, 473)),
                                          ((15, 15), (3, 3)),
                                          ((16, 12), (2, 2))])
def test_resize_and_pool_match(rng, hw_in, hw_out):
    x = rng.normal(size=(1, 4) + hw_in).astype(np.float32)
    xt = torch.tensor(x)
    want = np.moveaxis(np.asarray(j_resize(jnp.asarray(_nhwc(x)), hw_out,
                                           align_corners=False)), -1, 1)
    np.testing.assert_allclose(resize_bilinear(xt, hw_out).numpy(), want,
                               atol=1e-5, rtol=0)
    if hw_out[0] <= hw_in[0]:
        want = np.moveaxis(np.asarray(j_pool(jnp.asarray(_nhwc(x)), hw_out)),
                           -1, 1)
        np.testing.assert_allclose(adaptive_avg_pool(xt, hw_out).numpy(),
                                   want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw_in,hw_out", [((60, 60), (473, 473)),
                                          ((5, 7), (33, 17)),
                                          ((9, 9), (1, 1)),
                                          ((1, 1), (60, 60)),
                                          ((1, 6), (4, 1)),
                                          ((12, 10), (5, 3))])
def test_resize_align_corners_matches(rng, hw_in, hw_out):
    """align_corners=True (PSPNet, PPM, ASPP): source i * (in - 1) /
    (out - 1), with the out = 1 and in = 1 edges."""
    x = rng.normal(size=(2, 3) + hw_in).astype(np.float32)
    want = np.moveaxis(np.asarray(j_resize(jnp.asarray(_nhwc(x)), hw_out,
                                           align_corners=True)), -1, 1)
    got = resize_bilinear(torch.tensor(x), hw_out, align_corners=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bins", [2, 3, 6])
def test_adaptive_pool_uneven_bins_matches(rng, bins):
    """A 5 x 5 map at the PPM bins, which do not divide it (and bin 6,
    above the map's size)."""
    x = rng.normal(size=(1, 4, 5, 5)).astype(np.float32)
    want = np.moveaxis(np.asarray(j_pool(jnp.asarray(_nhwc(x)),
                                         (bins, bins))), -1, 1)
    got = adaptive_avg_pool(torch.tensor(x), (bins, bins))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _preds(rng):
    t = rng.integers(0, K, (3, 23, 17))
    p = np.where(rng.random(t.shape) < 0.6, t, rng.integers(0, K, t.shape))
    ign = rng.random(t.shape) < 0.1
    t[ign] = -1
    p[ign] = -1  # pred is ignore-masked at ignored pixels, as in SEA
    return p, t


def test_metrics_match_exactly(rng):
    p, t = _preds(rng)
    pj, tj = jnp.asarray(p.astype(np.int32)), jnp.asarray(t.astype(np.int32))
    pt, tt = torch.tensor(p), torch.tensor(t)
    h_want = np.asarray(jm.confusion_matrix(pj, tj, num_classes=K))
    h_got = tm.confusion_matrix(pt, tt, num_classes=K)
    assert np.array_equal(h_got.numpy(), h_want)
    i_w, u_w = jm.per_image_intersect_union(pj, tj, num_classes=K)
    i_g, u_g = tm.per_image_intersect_union(pt, tt, num_classes=K)
    assert np.array_equal(i_g.numpy(), np.asarray(i_w))
    assert np.array_equal(u_g.numpy(), np.asarray(u_w))
    assert np.array_equal(tm.per_image_pixel_acc(pt, tt).numpy(),
                          np.asarray(jm.per_image_pixel_acc(pj, tj)))
    for fj, ft in ((jm.iou_from_hist, tm.iou_from_hist),
                   (jm.f1_from_hist, tm.f1_from_hist),
                   (jm.pixel_acc_from_hist, tm.pixel_acc_from_hist)):
        for a, b in zip(ft(h_got), fj(jnp.asarray(h_want))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       equal_nan=True)
