"""The frozen reference agrees with ``robseg_torch`` on the CPU at small
sizes: the networks, the SEA losses' input gradients, the Linf step and
the scoring."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO
from portbench import inputs
from portbench.reference import attack, metrics, nets

CONFIGS = ("upernet-convnext-t-voc", "segmenter-vit-s-ade20k")


def config(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def both(name, seed=11):
    from robseg_torch.models import build_model
    cfg = config(name)
    sd = inputs.state_dict(cfg, seed, "cpu")
    ref = nets.build(cfg)
    ref.load_state_dict(sd)
    prog = build_model(cfg["model"]["name"], cfg["model"]["backbone"],
                       cfg["n_cls"], image_size=cfg["image_size"])
    prog.load_state_dict(sd)
    return cfg, sd, ref.eval(), prog.eval()


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", CONFIGS)
def test_networks_and_loss_gradients_agree(name):
    from robseg_torch.ops.losses import ATTACK_CRITERIA, pixel_to_img_loss
    cfg, _, ref, prog = both(name)
    x = inputs.images(5, "t", 2, (65, 63), "cpu")
    with torch.no_grad():
        want = ref(x)
        got = prog(x)
    assert rel(got, want) < 1e-5
    y = torch.where(inputs.ignore_mask(5, "i", 2, (65, 63), 0.2, "cpu"), -1,
                    want.argmax(1))
    w = torch.tensor(cfg["class_weights"])
    prog.requires_grad_(False)
    for loss in ("mask-ce-bal", "mask-ce-avg", "js-avg", "ce-avg"):
        _, g_ref = attack.loss_input_grad(ref, x, y, loss, w)
        xg = x.clone().requires_grad_(True)
        total = pixel_to_img_loss(ATTACK_CRITERIA[loss](prog(xg), y, w),
                                  (y != -1).float()).sum()
        (g,) = torch.autograd.grad(total, xg)
        assert rel(g, g_ref) < 1e-4, loss


def test_linf_step_agrees():
    from robseg_torch.kernels.apgd_step import apgd_linf_step_plain
    g = torch.Generator().manual_seed(0)
    x, xa, xo, gr = (torch.rand(3, 3, 9, 9, generator=g) for _ in range(4))
    step = torch.rand(3, generator=g) * 0.03
    for a in (1.0, 0.75):
        want = attack.apgd_linf_step(x, xa, xo, gr - 0.5, step, 8 / 255, a)
        got = apgd_linf_step_plain(x, xa, xo, gr - 0.5, step, 8 / 255, a)
        assert float((got - want).abs().max()) <= 1e-7


def test_scoring_agrees():
    from robseg_torch.ops.metrics import (iou_acc_summary,
                                          per_image_intersect_union)
    g = torch.Generator().manual_seed(1)
    y = torch.randint(-1, 21, (3, 17, 19), generator=g)
    pred = torch.where(y == -1, -1, torch.randint(0, 21, (3, 17, 19),
                                                  generator=g))
    inter, union, hist = metrics.per_image_counts(pred, y, 21)
    i, u = per_image_intersect_union(pred, y, num_classes=21)
    assert torch.equal(i, inter.float()) and torch.equal(u, union.float())
    got = [float(v) for v in iou_acc_summary(pred, y, num_classes=21)]
    assert got == pytest.approx(list(metrics.summary(hist)), abs=1e-6)
