"""``portbench/flops.py`` against a hand count."""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench import flops


def test_two_layer_net_hand_count():
    b, i, h, o = 3, 8, 16, 4
    with torch.device("meta"):
        net = nn.Sequential(nn.Linear(i, h), nn.ReLU(), nn.Linear(h, o))
        x = torch.empty(b, i, requires_grad=True)
    fwd = 2 * b * i * h + 2 * b * h * o
    assert flops.count(lambda: net(x)) == fwd
    # backward with weight gradients and the input gradient: two products
    # a layer
    assert flops.count(lambda: net(x).sum().backward()) == 3 * fwd
    net.requires_grad_(False)
    # input gradient only: one product a layer
    assert flops.count(lambda: net(x).sum().backward()) == 2 * fwd


def test_a_conv_counts_its_multiply_adds():
    with torch.device("meta"):
        conv = nn.Conv2d(4, 6, 3, padding=1, groups=2)
        x = torch.empty(2, 4, 5, 5)
    assert flops.count(lambda: conv(x)) == 2 * 2 * 6 * 2 * 9 * 25
