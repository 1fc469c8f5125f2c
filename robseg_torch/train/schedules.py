"""LR schedules as plain ``step -> lr`` functions.

A copy of ``robseg_tpu/train/schedules.py`` in Python floats (reference
``semseg/schedulers.py``):
  * ``warmup_poly_lr``: ``WarmupPolyLR`` with linear or exp warmup;
  * ``warmup_cosine_lr``: ``WarmupCosineLR``, including the reference's
    quirk of putting the raw step, not the step after warmup, in the
    cosine's numerator (``:184``);
  * ``poly_lr``: poly decay, the intent of ``PolyLR`` (whose modulo guard
    freezes it at the base lr in the reference, ``:73``);
  * ``polynomial_lr_timm`` (the Segmenter's) and ``poly_learning_rate``;
  * the factory ``get_scheduler``.
"""

from __future__ import annotations

import math
from typing import Callable


def _warmup_ratio(step, warmup_iter, warmup_ratio, kind):
    alpha = step / max(warmup_iter, 1)
    if kind == "linear":
        return warmup_ratio + (1.0 - warmup_ratio) * alpha
    return warmup_ratio ** (1.0 - alpha)  # exp


def warmup_poly_lr(base_lr: float, power: float, max_iter: int,
                   warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                   warmup: str = "linear") -> Callable:
    """``WarmupPolyLR``; the factory passes warmup='linear'."""
    def fn(step):
        step = float(step)
        if step < warmup_iter:
            return base_lr * _warmup_ratio(step, warmup_iter, warmup_ratio,
                                           warmup)
        alpha = (step - warmup_iter) / max(max_iter - warmup_iter, 1)
        return base_lr * max(1.0 - alpha, 0.0) ** power
    return fn


def warmup_cosine_lr(base_lr: float, max_iter: int, eta_ratio: float = 0.0,
                     warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                     warmup: str = "exp") -> Callable:
    """``WarmupCosineLR`` with the raw step in the cosine's numerator."""
    def fn(step):
        step = float(step)
        if step < warmup_iter:
            return base_lr * _warmup_ratio(step, warmup_iter, warmup_ratio,
                                           warmup)
        real_max = max(max_iter - warmup_iter, 1)
        return base_lr * (eta_ratio + (1 - eta_ratio) * (
            1 + math.cos(math.pi * step / real_max)) / 2)
    return fn


def poly_lr(base_lr: float, max_iter: int, power: float = 0.9) -> Callable:
    """Poly decay, ``base_lr * max(1 - step / max_iter, 0) ** power``."""
    def fn(step):
        return base_lr * max(1.0 - float(step) / max_iter, 0.0) ** power
    return fn


def polynomial_lr_timm(base_lr: float, iter_max: int, power: float = 0.9,
                       iter_warmup: int = 0, min_lr: float = 1e-5
                       ) -> Callable:
    """The Segmenter's schedule: timm's ``PolynomialLR`` with
    ``optim_args_segmenter``'s defaults."""
    def fn(step):
        step = float(step)
        if step < iter_warmup:
            coef = (step / iter_warmup) * (
                1 - iter_warmup / iter_max) ** power
        else:
            coef = max(1.0 - step / iter_max, 0.0) ** power
        return (base_lr - min_lr) * coef + min_lr
    return fn


def poly_learning_rate(base_lr: float, curr_iter, max_iter: int,
                       power: float = 0.9) -> float:
    """The raw helper of the reference's PSPNet path."""
    return base_lr * (1 - float(curr_iter) / max_iter) ** power


def get_scheduler(name: str, base_lr: float, max_iter: int, power: float,
                  warmup_iter: int, warmup_ratio: float) -> Callable:
    """Factory; parity ``get_scheduler`` (``schedulers.py:198-225``)."""
    name = name.lower()
    if name == "warmuppolylr":
        return warmup_poly_lr(base_lr, power, max_iter, warmup_iter,
                              warmup_ratio, warmup="linear")
    if name == "warmupcosinelr":
        return warmup_cosine_lr(base_lr, max_iter, warmup_iter=warmup_iter,
                                warmup_ratio=warmup_ratio)
    if name in ("polylr", "warmupsteplr", "warmuplr"):
        return poly_lr(base_lr, max_iter)
    raise ValueError(f"Unavailable scheduler name >> {name}")
