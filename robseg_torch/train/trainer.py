"""PIR-AT trainer: an adversarial attack in eval mode, then the update in
train mode, on one card or data-parallel over several.

Port of ``robseg_tpu/train/trainer.py`` (reference ``tools/
train_rob_seg.py``, ``Trainer``):
  * the adversarial examples are made with the model in eval mode
    (``:333-335``): ``pgd_attack`` (``TRAIN.ATTACK: pgd``) or, under
    ``apgd``, Linf ``apgd_attack`` with a random start and ``ce-avg``,
    whose ``x_best`` the update takes (the reference's intent; its call
    there raises); any other name raises when the trainer is built;
  * the loss per family (``make_loss_fn``): UperNet's ``(loss, _) =
    model(x, y)``, PSPNet's main + 0.4 aux (``:338-347``), and CE on the
    logits for the others;
  * the update: forward and backward in train mode, one optimizer step
    with the scheduled lr.

The attack runs on a *twin*: a module with the same parameter names
(``build_model(..., fused=True)``, whose ConvNeXt blocks are the block
kernels; or the plain module), called through
``torch.func.functional_call`` on this step's parameters, detached, and
this step's BatchNorm statistics. It holds no weights of its own that the
attack reads (it may live on the ``meta`` device), so it never goes stale,
and the attack's input gradients touch no parameter's ``.grad``. The eval
step accumulates the confusion matrix through
``ops.metrics.confusion_matrix`` (the confusion kernel on the card).

Data parallelism (``group``, the JAX ``shard_map`` step,
``robseg_tpu/train/trainer.py:91-195``): each rank trains on its shard of
the global batch. The attack stays on the rank (no collective runs in
it); after the backward pass the gradients are averaged over the ranks in
one all-reduce, and so is the loss; each BatchNorm normalises with its
rank's batch statistics (no ``SyncBatchNorm``), and the running
statistics are averaged after the step, so the replicas stay identical.
An explicit all-reduce, not DDP: DDP's default ``broadcast_buffers``
copies rank 0's running statistics instead of averaging them, and its
hooks would reduce once per bucket during the backward instead of once
after it. Dropout and DropPath draw from the rank's generator, seeded at
each step from (seed, step, rank), as JAX folds the step and
``axis_index`` into its key. The eval step's confusion matrix is summed
over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from robseg_torch.attacks.apgd import apgd_attack
from robseg_torch.attacks.pgd import pgd_attack
from robseg_torch.models.layers import set_generator
from robseg_torch.ops.losses import segmentation_cross_entropy
from robseg_torch.ops.metrics import (confusion_matrix, f1_from_hist,
                                      iou_from_hist, pixel_acc_from_hist)
from robseg_torch.parallel import DataGroup, all_mean_, all_sum_, fold_seed
from robseg_torch.train.optim import ScheduledOptimizer


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """The training attack: the TRAIN section and ``Pgd_Attack``'s
    defaults (``tools/train_rob_seg.py:293-301``)."""
    enabled: bool = True
    name: str = "pgd"          # TRAIN.ATTACK
    loss_fn: str = "pgd"       # TRAIN.LOSS_FN
    eps: float = 4.0 / 255.0   # TRAIN.EPS / 255
    n_iters: int = 5           # TRAIN.N_ITERS
    alpha: float = 1e-2


def make_loss_fn(model_name: str) -> Callable:
    """``(module, x, y) -> loss`` of the family, the module in train
    mode."""
    if model_name == "PSPNet":
        def loss_fn(module, x, y):
            main_loss, aux_loss, _ = module(x, y)
            return main_loss + 0.4 * aux_loss
    elif model_name == "UperNetForSemanticSegmentation":
        def loss_fn(module, x, y):
            return module(x, y)[0]
    elif model_name in ("PSPNet_DDCAT", "DeepLabV3_DDCAT"):
        raise ValueError(
            f"{model_name}: the JAX trainer hands its train tuple (final, "
            "aux, a 2-class mask, normal) to the class-label CE, which "
            "cannot take the mask; no DDCAT train loss is defined")
    else:  # SegMenter, DeepLabV3
        def loss_fn(module, x, y):
            return segmentation_cross_entropy(module(x), y, -1)
    return loss_fn


class Trainer:
    """The train and eval steps over ``module`` (trained in place).

    ``twin``: the module the attack runs through (same parameter names);
    ``None`` means ``module`` itself, switched to eval mode for the
    attack. ``generator`` (on the module's device) drives DropPath,
    dropout and the APGD random start; its state is part of
    ``state_dict``. ``group``: train data-parallel (the module's
    docstring); the images of each step are this rank's shard, and
    ``generator`` is reseeded at each step from its seed, the step and the
    rank."""

    def __init__(self, module: nn.Module, model_name: str,
                 optimizer: ScheduledOptimizer, attack: AttackConfig,
                 twin: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None,
                 group: Optional[DataGroup] = None):
        if attack.enabled and attack.name not in ("pgd", "apgd"):
            # the reference's non-pgd branch passes a nonexistent gpuu=
            # kwarg (train_rob_seg.py:303-315)
            raise ValueError(f"TRAIN.ATTACK must be 'pgd' or 'apgd', "
                             f"got {attack.name!r}")
        self.module = module.train()
        self.loss_fn = make_loss_fn(model_name)
        self.optimizer = optimizer
        self.attack_cfg = attack
        self.twin = twin
        self.generator = generator
        set_generator(module, generator)
        self.group = group
        self.seed = None if generator is None else generator.initial_seed()
        self.step = 0

    @contextlib.contextmanager
    def attack_model(self):
        """``x -> logits`` that the attack differentiates: the twin (or,
        with none, the module) in eval mode on this step's parameters
        (detached) and BatchNorm statistics."""
        twin = self.twin if self.twin is not None else self.module
        tensors = {k: v.detach() for k, v in self.module.named_parameters()}
        tensors.update(self.module.named_buffers())
        was_training = twin.training
        twin.eval()
        try:
            yield lambda x: functional_call(twin, tensors, (x,))
        finally:
            twin.train(was_training)

    def attack(self, images: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
        """The adversarial batch (detached) of the configured attack,
        through :meth:`attack_model`."""
        a = self.attack_cfg
        with self.attack_model() as lf:
            if a.name == "apgd":
                x = apgd_attack(lf, images, labels, norm="Linf", eps=a.eps,
                                n_iter=a.n_iters, use_rs=True, loss="ce-avg",
                                generator=self.generator).x_best
            else:
                x = pgd_attack(lf, images, labels, eps=a.eps, alpha=a.alpha,
                               num_iter=a.n_iters, loss=a.loss_fn)
        return x.detach()

    def train_step(self, images: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
        """One PIR-AT step; returns the loss (detached, on the device; the
        mean over the ranks under ``group``)."""
        if self.group is not None and self.generator is not None:
            self.generator.manual_seed(
                fold_seed(self.seed, self.step, self.group.rank))
        x = self.attack(images, labels) if self.attack_cfg.enabled \
            else images
        self.module.train()
        self.optimizer.zero_grad()
        loss = self.loss_fn(self.module, x, labels)
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            all_mean_([p.grad for p in self.module.parameters()
                       if p.grad is not None] + [loss], self.group)
            all_mean_([b for n, b in self.module.named_buffers()
                       if n.endswith(("running_mean", "running_var"))],
                      self.group)
        self.optimizer.step(self.step)
        self.step += 1
        return loss

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, labels: torch.Tensor,
                  hist: torch.Tensor) -> torch.Tensor:
        """``hist`` plus the batch's confusion matrix, the module in eval
        mode (summed over the ranks' shards under ``group``)."""
        self.module.eval()
        try:
            pred = self.module(images).argmax(1)
        finally:
            self.module.train()
        inc = confusion_matrix(pred, labels, num_classes=hist.shape[0],
                               ignore_label=-1)
        all_sum_([inc], self.group)
        return hist + inc

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": None if self.generator is None
                else self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.module.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.generator is not None and state["generator"] is not None:
            self.generator.set_state(state["generator"])


def metrics_from_hist(hist: torch.Tensor) -> Dict[str, Any]:
    """(class_acc, mAcc, aAcc, f1, mF1, ious, mIoU), ``val.py:14-32``."""
    hist = hist.detach().float().cpu()
    acc, macc, aacc = pixel_acc_from_hist(hist)
    f1, mf1 = f1_from_hist(hist)
    ious, miou = iou_from_hist(hist)
    return {"class_acc": acc.numpy(), "mAcc": float(macc),
            "aAcc": float(aacc), "f1": f1.numpy(), "mF1": float(mf1),
            "ious": ious.numpy(), "mIoU": float(miou)}
