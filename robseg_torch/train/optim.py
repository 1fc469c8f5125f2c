"""Optimizers with decay/no-decay parameter groups and per-group lr scales.

Port of ``robseg_tpu/train/optim.py`` on the port's parameter names
(reference ``semseg/optimizers.py``):
  * ``decay_mask``: weight decay where ``ndim > 1`` and no "norm" in the
    name (``group_weight``, ``optimizers.py:39-59``);
  * ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)`` or
    ``torch.optim.SGD(momentum=0.9)`` (``optimizers.py:27-36``);
  * ``pspnet_lr_scales``: backbone x1, the new modules x10
    (``train_rob_seg.py:185-204``);
  * ``layerwise_lr_scales``: the stage-wise ConvNeXt lr decay, opt-in as
    in the JAX package (the reference imports it and never calls it);
  * ``freeze_mask``: TRAIN.FREEZE, the backbone gets no update, weight
    decay included.

optax's per-leaf masks and scales become torch parameter groups, one per
(decay, scale) pair. ``ScheduledOptimizer.step(i)`` sets each group's lr
to ``schedule(i) * scale`` before the update, so the first update uses
``schedule(0)`` as optax's count does; a group's lr multiplies its weight
decay too, as in optax's chain and in torch.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

_RESNET_STAGE = re.compile(r"layer\d\.")


def in_backbone(name: str) -> bool:
    """A parameter of the backbone: ``backbone.*``, or PSPNet's reference
    layout ``layer0`` .. ``layer4``."""
    return name.startswith("backbone.") or bool(_RESNET_STAGE.match(name))


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies (ndim > 1 and no 'norm' in name)."""
    return {n: p.ndim > 1 and "norm" not in n
            for n, p in module.named_parameters()}


def stagewise_layer_id(name: str, num_layers: int) -> int:
    """``get_num_layer_stage_wise`` on the port's names: the ConvNeXt stem
    and downsamplers 0, stage i i + 1, position and class tokens 0, the
    rest (the per-stage norms included) the head group."""
    m = re.match(r"backbone\.(downsample_layers|stages)\.(\d+)\.", name)
    if m:
        return 0 if m[1] == "downsample_layers" else int(m[2]) + 1
    if "cls_token" in name or "pos_embed" in name or "mask_token" in name:
        return 0
    return num_layers - 1


def layerwise_lr_scales(module: nn.Module, *, decay_rate: float = 0.9,
                        num_layers: int = 8) -> Dict[str, float]:
    """Per-parameter lr multipliers decay_rate^(num_layers - id - 1)."""
    return {n: decay_rate ** (num_layers - stagewise_layer_id(n, num_layers)
                              - 1)
            for n, _ in module.named_parameters()}


def freeze_mask(module: nn.Module) -> Dict[str, bool]:
    """True where the parameter is frozen: the backbone's."""
    mask = {n: in_backbone(n) for n, _ in module.named_parameters()}
    if not any(mask.values()):
        raise ValueError(
            "TRAIN.FREEZE: model has no backbone parameters (top-level "
            f"modules: {sorted(n for n, _ in module.named_children())})")
    return mask


def pspnet_lr_scales(module: nn.Module) -> Dict[str, float]:
    """Backbone parameters x1, the new modules (ppm, cls, aux) x10."""
    return {n: 1.0 if in_backbone(n) else 10.0
            for n, _ in module.named_parameters()}


class ScheduledOptimizer:
    """A torch optimizer whose groups carry an ``lr_scale``; ``step(i)``
    sets every group's lr from ``schedule(i)`` and updates."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable):
        self.optimizer = optimizer
        self.schedule = schedule

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, i: int) -> None:
        lr = float(self.schedule(i))
        for g in self.optimizer.param_groups:
            g["lr"] = lr * g["lr_scale"]
        self.optimizer.step()

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state)


def make_optimizer(name: str, module: nn.Module, schedule: Callable, *,
                   weight_decay: float = 0.01, momentum: float = 0.9,
                   lr_scales: Optional[Dict[str, float]] = None,
                   frozen_mask: Optional[Dict[str, bool]] = None
                   ) -> ScheduledOptimizer:
    """AdamW / SGD over ``module``'s parameters with the decay mask and
    optional per-parameter lr scales. Frozen parameters are in no group
    and stop requiring grad, so they stay bit-identical."""
    mask = decay_mask(module)
    groups: Dict[tuple, dict] = {}
    for n, p in module.named_parameters():
        if frozen_mask is not None and frozen_mask[n]:
            p.requires_grad_(False)
            continue
        scale = 1.0 if lr_scales is None else float(lr_scales[n])
        key = (mask[n], scale)
        if key not in groups:
            groups[key] = {"params": [], "lr_scale": scale,
                           "weight_decay": weight_decay if mask[n] else 0.0}
        groups[key]["params"].append(p)
    params = list(groups.values())
    if name.lower() == "adamw":
        opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                eps=1e-8)
    elif name.lower() == "sgd":
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return ScheduledOptimizer(opt, schedule)
