"""SEA worst-case aggregation across the attack ensemble.

Port of ``robseg_tpu/attacks/worst_case.py``:

  * ``worst_case_aacc``: per-image aAcc per attack, min over attacks, mean
    over images;
  * ``sea_intersect_union``: the ``(A, N, K)`` per-attack per-image
    intersections and unions, through the port's ``ops/metrics.py`` (the
    confusion kernel for CUDA tensors);
  * ``worst_case_miou``: the greedy randomized worst-case mIoU search, with
    the JAX package's four engines. ``native`` and ``reference`` run
    ``robseg_torch/native/worst_case.cpp`` (a byte-for-byte copy of the JAX
    package's), built with ``g++`` at first use by ``kernels/_build.py``;
    ``python`` and ``reference-python`` are the numpy loops. ``auto`` means
    ``native``, as in the JAX package, so the default selects the attacks
    the JAX CLI's default selects.

One deliberate change from the JAX package: where its ``auto`` falls back
to the Python loop in silence when the C++ build fails (a different
shuffle, so a different printed number), here ``auto``, ``native`` and
``reference`` raise an error that names ``--wc_engine python``.
"""

from __future__ import annotations

import ctypes
import random
from typing import Sequence, Tuple

import numpy as np
import torch

from robseg_torch.ops.metrics import (per_image_intersect_union,
                                      per_image_pixel_acc)

SEED = 225  # parity: tools/worse_only.py:14
ENGINES = ("auto", "native", "python", "reference", "reference-python")


def worst_case_aacc(preds: Sequence, targets, *, ignore_label: int = -1,
                    device: torch.device = torch.device("cpu")
                    ) -> Tuple[float, np.ndarray]:
    """(worst-case mean aAcc, per-attack mean aAcc). ``preds``: one
    ``(N, H, W)`` argmax array per attack (already ignore-masked);
    ``targets``: ``(N, H, W)``."""
    t = torch.as_tensor(np.asarray(targets)).to(device)
    accs = np.stack([
        per_image_pixel_acc(torch.as_tensor(np.asarray(p)).to(device), t,
                            ignore_label=ignore_label).cpu().numpy()
        for p in preds])  # (A, N)
    return float(accs.min(0).mean()), accs.mean(-1)


def _miou_from(inters: np.ndarray, unions: np.ndarray) -> float:
    """Mean over classes with union > 0; parity ``worse_only.py:69-76``."""
    present = unions > 0
    return float((inters[present] / unions[present]).mean())


def sea_intersect_union(preds: Sequence, targets, *, num_classes: int,
                        ignore_label: int = -1, batch: int = 16,
                        device: torch.device = torch.device("cpu")
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``(A, N, K)`` per-attack per-image intersections and unions
    (float64), computed ``batch`` images at a time on ``device``."""
    targets = np.asarray(targets)
    a, n = len(preds), targets.shape[0]
    ints = np.zeros((a, n, num_classes), np.float64)
    unis = np.zeros((a, n, num_classes), np.float64)
    for ai, p in enumerate(preds):
        p = np.asarray(p)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            i_, u_ = per_image_intersect_union(
                torch.as_tensor(p[s:e]).to(device),
                torch.as_tensor(targets[s:e]).to(device),
                num_classes=num_classes, ignore_label=ignore_label)
            ints[ai, s:e] = i_.cpu().numpy()
            unis[ai, s:e] = u_.cpu().numpy()
    return ints, unis


def worst_case_miou(cons_ints: np.ndarray, cons_unions: np.ndarray, *,
                    n_rounds: int = 1000, tol: float = 1e-6,
                    seed: int = SEED, return_selection: bool = False,
                    engine: str = "auto"):
    """Greedy worst-case mIoU over ``(A, N, K)`` per-attack, per-image
    intersections and unions; parity ``worse_only.py:279-334``.

    ``engine``: ``native`` (C++, ``std::mt19937_64`` shuffle), ``python``
    (``random.Random`` shuffle; a different trajectory, the same minimum
    on small inputs), ``auto`` (= ``native``), and ``reference`` /
    ``reference-python``, the published code's class-list-shrink quirk
    (``worse_only.py:79-93``), trajectory-identical to each other."""
    if engine not in ENGINES:
        raise ValueError(f"unknown worst-case engine {engine!r}; one of "
                         f"{ENGINES}")
    kw = dict(n_rounds=n_rounds, tol=tol, seed=seed,
              return_selection=return_selection)
    if engine == "reference-python":
        return _worst_case_miou_reference_py(cons_ints, cons_unions, **kw)
    if engine == "reference":
        return _native_call("worst_case_miou_reference", cons_ints,
                            cons_unions, **kw)
    if engine in ("auto", "native"):
        return _native_call("worst_case_miou", cons_ints, cons_unions, **kw)
    return _worst_case_miou_py(cons_ints, cons_unions, **kw)


def _worst_case_miou_py(cons_ints, cons_unions, *, n_rounds, tol, seed,
                        return_selection):
    """The ``python`` engine (``robseg_tpu/attacks/worst_case.py:117-154``)."""
    rng = random.Random(seed)
    n_attacks, n_imgs, _ = cons_ints.shape
    selected = np.zeros((n_imgs,), np.int64)  # start from attack 0
    running_int = cons_ints[0].sum(0)
    running_uni = cons_unions[0].sum(0)
    final_miou = _miou_from(running_int, running_uni)

    prev_best = 10.0
    for _ in range(n_rounds):
        order = list(range(n_imgs))
        rng.shuffle(order)
        for idx in order:
            for attack in range(n_attacks):
                new_int = running_int + (cons_ints[attack, idx]
                                         - cons_ints[selected[idx], idx])
                new_uni = running_uni + (cons_unions[attack, idx]
                                         - cons_unions[selected[idx], idx])
                # skip classes whose *current* union is 0 when scoring the
                # candidate (worse_only.py:79-93)
                present = running_uni > 0
                est = float(np.mean(
                    new_int[present] / (new_uni[present] + 1e-8)))
                if est < final_miou:
                    selected[idx] = attack
                    running_int = new_int
                    running_uni = new_uni
            # the acceptance threshold is recomputed after every image
            # (worse_only.py:323-326)
            final_miou = _miou_from(running_int, running_uni)
        if prev_best - final_miou <= tol:
            break
        prev_best = final_miou
        final_miou = _miou_from(running_int, running_uni)

    if return_selection:
        return final_miou, selected
    return final_miou


def _worst_case_miou_reference_py(cons_ints, cons_unions, *, n_rounds, tol,
                                  seed, return_selection):
    """Bug-compatible transcription of ``worse_only.py:181-349``: the
    running intersection and union are Python lists; the candidate scorer
    zips them against the K-length update vectors (truncating to the
    shorter), drops entries whose current union is zero and returns the
    shrunk lists, which an accepted swap installs as the running state."""
    rng = random.Random(seed)
    n_attacks, n_imgs, _ = cons_ints.shape
    selected = np.zeros((n_imgs,), np.int64)
    run_i = [float(v) for v in cons_ints[0].sum(0)]
    run_u = [float(v) for v in cons_unions[0].sum(0)]

    def _miou(ri, ru):
        vals = [a / b for a, b in zip(ri, ru) if b != 0]
        return sum(vals) / len(vals) if vals else 0.0

    final_miou = _miou(run_i, run_u)
    prev_best = 10.0
    for _ in range(n_rounds):
        order = list(range(n_imgs))
        rng.shuffle(order)
        for idx in order:
            for attack in range(n_attacks):
                upd_i = cons_ints[attack, idx] - cons_ints[selected[idx], idx]
                upd_u = (cons_unions[attack, idx]
                         - cons_unions[selected[idx], idx])
                new_i, new_u, mious = [], [], []
                # zip truncates to len(run_i): the reference's shrink bug
                for a, b, c, d in zip(run_i, run_u, upd_i, upd_u):
                    if b == 0:  # skip classes absent from the CURRENT union
                        continue
                    new_i.append(a + float(c))
                    new_u.append(b + float(d))
                    mious.append(new_i[-1] / (new_u[-1] + 1e-8))
                est = sum(mious) / len(mious) if mious else 0.0
                if est < final_miou:
                    selected[idx] = attack
                    run_i, run_u = new_i, new_u
            final_miou = _miou(run_i, run_u)
        if prev_best - final_miou <= tol:
            break
        prev_best = final_miou
        final_miou = _miou(run_i, run_u)

    if return_selection:
        return final_miou, selected
    return final_miou


_ARGTYPES = [ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_double, ctypes.c_uint64,
             ctypes.POINTER(ctypes.c_int64)]


def _native_call(symbol, cons_ints, cons_unions, *, n_rounds, tol, seed,
                 return_selection):
    """One engine of ``native/worst_case.cpp`` through ``ctypes``."""
    from robseg_torch.kernels import _build
    try:
        lib = _build.native_library("worst_case")
    except (RuntimeError, OSError) as e:
        raise RuntimeError(
            f"the native worst-case engine could not be built or loaded "
            f"({e}); run with --wc_engine python (or "
            f"engine='python'), which selects with another shuffle and so "
            f"may print another final_miou") from e
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_double
    fn.argtypes = _ARGTYPES
    a, n, k = cons_ints.shape
    ints = np.ascontiguousarray(cons_ints, np.float64)
    unis = np.ascontiguousarray(cons_unions, np.float64)
    selected = np.zeros((n,), np.int64)
    miou = fn(ints.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
              unis.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
              a, n, k, n_rounds, tol, seed,
              selected.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if return_selection:
        return float(miou), selected
    return float(miou)
