"""The port's contrastive losses, seeds and parameter counts, palettes,
profiling and FLOP counting against the JAX package's modules, on the CPU.

Tolerances: the losses 1e-5 (float32 on both sides); palettes, masks,
overlays and annotated images byte for byte (the same numpy and PIL
code); parameter counts exact; FLOPs exactly 2 per multiply-add.
"""

import json
import os
import random

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_tpu.ops import contrastive as jc
from robseg_tpu.utils import misc as jmisc
from robseg_tpu.utils import visualize as jvis
from robseg_torch.models import build_model
from robseg_torch.ops import contrastive as tc
from robseg_torch.utils import misc as tmisc
from robseg_torch.utils import visualize as tvis
from robseg_torch.utils.flops import cost_analysis, pretty_flops
from robseg_torch.utils.profiling import StepTimer, trace
from test_torch_train_models import K, narrow_upernet, two_threads  # noqa: F401,E501


def _emb(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_nt_xent_loss_matches_jax(temperature):
    a, b = _emb(0, 4, 3, 5), _emb(1, 4, 3, 5)
    want = jc.nt_xent_loss(jnp.asarray(a), jnp.asarray(b), temperature)
    got = tc.nt_xent_loss(torch.tensor(a), torch.tensor(b), temperature)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("reduction,targeted,alpha", [
    ("mean", False, 0.0), ("none", False, 0.0), ("mean", True, 0.0),
    ("none", True, 0.0), ("mean", True, 1.0), ("none", True, 1.0)])
def test_ce_unsup_matches_jax(reduction, targeted, alpha):
    out, tgt = _emb(2, 5, 2, 4), _emb(3, 5, 2, 4)
    want = jc.ce_unsup(jnp.asarray(out), jnp.asarray(tgt), reduction,
                       targeted, alpha)
    got = tc.ce_unsup(torch.tensor(out), torch.tensor(tgt), reduction,
                      targeted, alpha)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_ce_unsup_refuses_other_alphas():
    out = _emb(4, 3, 4)
    with pytest.raises(ValueError, match="alpha"):
        jc.ce_unsup(jnp.asarray(out), jnp.asarray(out), targeted=True,
                    alpha=0.5)
    with pytest.raises(ValueError, match="alpha"):
        tc.ce_unsup(torch.tensor(out), torch.tensor(out), targeted=True,
                    alpha=0.5)


# ------------------------------------------------------------- palettes

def test_palettes_match_jax():
    assert np.array_equal(tvis.ADE_PALETTE, jvis.ADE_PALETTE)
    assert tvis.ADE_PALETTE.dtype == np.uint8
    for n in (21, 30):
        assert np.array_equal(tvis.voc_palette(n), jvis.voc_palette(n))
    for n in (150, 21, 7, 40):
        for bg in (False, True):
            assert np.array_equal(tvis.generate_palette(n, bg),
                                  jvis.generate_palette(n, bg))
    assert np.array_equal(tvis.hsv_palette(40, seed=3),
                          jvis.hsv_palette(40, seed=3))


@pytest.mark.parametrize("k", [21, 150, 9])
def test_colorize_and_overlay_match_jax(k):
    rng = np.random.default_rng(k)
    mask = rng.integers(-1, k, (12, 10))
    img = rng.random((12, 10, 3)).astype(np.float32)
    for kw in ({}, {"num_classes": k},
               {"palette": jvis.generate_palette(k, True)}):
        got, want = tvis.colorize_mask(mask, **kw), jvis.colorize_mask(
            mask, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(tvis.overlay(img, got, 0.3),
                          jvis.overlay(img, want, 0.3))


def test_draw_text_matches_jax():
    rng = np.random.default_rng(5)
    seg = np.zeros((40, 60), np.int64)
    seg[:, 30:] = 2
    seg[25:, :20] = 1
    img = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
    labels = ["sky", "road", "car"]
    got = np.asarray(tvis.draw_text(img, seg, labels, fontsize=10))
    want = np.asarray(jvis.draw_text(img, seg, labels, fontsize=10))
    assert got.shape == (40, 60, 3) and np.array_equal(got, want)
    assert not np.array_equal(got, img)


# ------------------------------------------------- seeds and counting

def test_fix_seeds_seeds_every_stream():
    g = tmisc.fix_seeds(7)
    draws = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    g2 = tmisc.fix_seeds(7)
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item(),
                     torch.rand(1, generator=g2).item())
    jmisc.fix_seeds(7)   # JAX's pins the same host streams
    assert (random.random(), np.random.rand()) == draws[:2]


def test_model_param_count_matches_jax(monkeypatch):
    narrow_upernet(monkeypatch)
    jm = JUN(backbone_variant="T_CVST", num_classes=K)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))
    want = jmisc.model_param_count(v["params"])
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", K,
                    fused=False)
    assert tmisc.model_param_count(m) == want
    assert tmisc.model_size_mb(m) == pytest.approx(want * 4 / 1024 ** 2)
    assert tmisc.model_size_mb(m.to(torch.bfloat16)) == pytest.approx(
        want * 2 / 1024 ** 2)


# ------------------------------------------------------ FLOPs, profiling

def test_cost_analysis_counts_two_flops_a_multiply_add():
    conv = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1)
    x = torch.rand(2, 8, 20, 20)               # output 10 x 10
    macs = 2 * 16 * 10 * 10 * 8 * 9
    assert cost_analysis(conv, x) == {"flops": 2.0 * macs}
    lin = torch.nn.Linear(24, 40)
    assert cost_analysis(lin, torch.rand(3, 5, 24)) == {
        "flops": 2.0 * 15 * 24 * 40}
    assert pretty_flops(lin, torch.rand(3, 5, 24)).startswith(
        f"{2 * 15 * 24 * 40 / 1e9:.2f} GFLOPs")


def test_step_timer_and_trace_on_cpu(tmp_path):
    timer = StepTimer()
    assert timer.summary() == "no steps timed"
    x = torch.rand(64, 64)
    for _ in range(3):
        timer.start()
        y = x @ x
        timer.stop(y)
    assert len(timer.times) == 3 and timer.mean > 0
    assert timer.summary().startswith("steps=3 mean=")
    with trace(None):
        (x @ x).sum()
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path)):
        (x @ x).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
