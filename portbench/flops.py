"""Model FLOPs of a unit of a cell's work, counted on the plain reference.

The reference's forward and backward run once at the cell's shapes on the
``meta`` device under ``torch.utils.flop_counter.FlopCounterMode``, which
counts the products (convolutions, matrix products, attention) at 2 FLOPs
a multiply-add from their shapes, and nothing else. A backward counts only
the gradients it computes: an attack's pass computes the input gradient and
no weight gradient. That is the work of the model whatever implements it,
so no kernel of the program can hide a product from it, and nothing the
program recomputes is counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import attack, nets


def count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta_net(cfg: dict):
    with torch.device("meta"):
        net = nets.build(cfg)
    return net.eval()


def attack_pass(cfg: dict, batch: int, hw, loss: str = "ce-avg") -> float:
    """FLOPs of one image's forward and input gradient (one attack
    iteration), counted at ``batch`` images and divided by it."""
    net = _meta_net(cfg).requires_grad_(False)
    x = torch.empty((batch, 3, *hw), device="meta", requires_grad=True)
    y = torch.zeros((batch, *hw), dtype=torch.long, device="meta")

    def step():
        attack.image_loss(loss, net(x), y).sum().backward()
    return count(step) / batch
