"""SEA, the Segmentation Ensemble Attack: orchestration and aggregation.

Port of ``robseg_tpu/attacks/sea.py``. For each of the three losses
``apgd_largereps`` attacks every batch; the adversarial batch is argmaxed
and reduced at once to its confusion-matrix increment, per-image
intersection/union and per-image aAcc; the worst case over the attacks is
aggregated at the end.

Batches are ``(x, y)``: images ``(B, 3, H, W)`` in [0, 1] and labels
``(B, H, W)``, numpy or torch; they are moved to ``device``.

``group`` (a ``parallel.DataGroup``, in place of the JAX ``mesh``,
``--shard``): every rank reads the whole batch, pads it to a multiple of
the world size (padded rows all-ignore) and attacks and evaluates its own
contiguous rows. The random start is drawn on every rank with the
one-process generator chain over the batch the one-process run attacks
(the first batch's size), then sliced, so each image starts where it
starts there and the generator moves on as it does there, whatever the
padding; the early stop is decided over the whole batch; the confusion
matrices are all-reduced and the per-image results gathered, so every
rank ends with the whole set and per-image results equal the
one-process run's. Only rank 0 prints, and reads and writes the
``resume_dir`` files; it sends what it reads to every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from robseg_torch.attacks.apgd import apgd_largereps
from robseg_torch.attacks.worst_case import worst_case_miou
from robseg_torch.ops.metrics import (confusion_matrix, f1_from_hist,
                                      iou_from_hist,
                                      per_image_intersect_union,
                                      per_image_pixel_acc,
                                      pixel_acc_from_hist)
from robseg_torch.parallel import (DataGroup, all_sum_, broadcast_object,
                                   gather_objects, gather_rows, is_main,
                                   shard_batch)

# argmax predictions on host/cache: class ids and -1 fit in 2 bytes
PRED_DTYPE = np.int16

SEA_LOSSES = ("mask-ce-bal", "mask-ce-avg", "js-avg")  # infer.py:276-280


def _img_stats(adv: np.ndarray, x: np.ndarray, norm: str) -> tuple:
    """(largest perturbation, NaN count, largest, smallest entry)."""
    delta = (adv - x).reshape(adv.shape[0], -1)
    if norm == "Linf":
        res = np.abs(delta).max(1)
    elif norm == "L2":
        res = np.sqrt((delta ** 2).sum(1))
    elif norm == "L1":
        res = np.abs(delta).sum(1)
    else:
        raise ValueError(norm)
    return res.max(), np.isnan(adv).sum(), adv.max(), adv.min()


def _format_stats(norm: str, stats: tuple) -> str:
    pert, nan, hi, lo = stats
    return (f"max {norm} pert: {pert:.5f}, nan in imgs: {nan}, max in "
            f"imgs: {hi:.5f}, min in imgs: {lo:.5f}")


def check_imgs(adv: np.ndarray, x: np.ndarray, norm: str) -> str:
    """Perturbation-validity invariants; parity ``tools/infer.py:39-53``."""
    return _format_stats(norm, _img_stats(adv, x, norm))


def _check_shards(adv: torch.Tensor, x: torch.Tensor, norm: str,
                  group: Optional[DataGroup]) -> str:
    """``check_imgs`` of the whole batch from each rank's rows (``adv``
    and ``x`` the real rows this rank holds, possibly none)."""
    parts = gather_objects(
        _img_stats(adv.cpu().numpy(), x.cpu().numpy(), norm)
        if adv.shape[0] else None, group)
    parts = [p for p in parts if p is not None]
    return _format_stats(norm, (max(p[0] for p in parts),
                                sum(p[1] for p in parts),
                                max(p[2] for p in parts),
                                min(p[3] for p in parts)))


@dataclasses.dataclass
class EvalStats:
    m_acc: float
    a_acc: float
    m_iou: float

    def as_dict(self) -> Dict[str, float]:
        return {"mAcc": self.m_acc, "aAcc": self.a_acc, "mIoU": self.m_iou}


def _to_device(x, y, device):
    x = torch.as_tensor(x).to(device)
    y = torch.as_tensor(y).to(device=device, dtype=torch.int64)
    return x, y


def _pad_batch(x: torch.Tensor, y: torch.Tensor, bs: int):
    """Pad a trailing partial batch to the full batch size: padded rows get
    label = ignore everywhere, so they count in no metric; callers slice
    the predictions back to ``n_real``."""
    n_real = x.shape[0]
    if n_real == bs:
        return x, y, n_real
    reps = bs - n_real
    x = torch.cat([x, x[-1:].expand((reps,) + x.shape[1:])])
    y = torch.cat([y, torch.full((reps,) + y.shape[1:], -1, dtype=y.dtype,
                                 device=y.device)])
    return x, y, n_real


def _static_batch_size(first_batch_size: int,
                       group: Optional[DataGroup]) -> int:
    """The batch size every call gets: the first batch's, rounded up to a
    multiple of the world size under ``group`` (``:69-94``)."""
    if group is None:
        return first_batch_size
    return -(-first_batch_size // group.size) * group.size


def _real_rows(n_real: int, group: Optional[DataGroup], bs: int) -> slice:
    """The rows of this rank's shard (of a batch of ``bs``) that are real
    images, not padding."""
    if group is None:
        return slice(0, n_real)
    per = bs // group.size
    return slice(0, max(min(n_real - group.rank * per, per), 0))


def _eval_step(logits_fn: Callable, x, y, hist, *, num_classes: int,
               ignore_label: int = -1, group: Optional[DataGroup] = None):
    """Argmax prediction (ignore-masked) and the updated confusion matrix
    (the increment summed over the ranks under ``group``)."""
    with torch.no_grad():
        pred = logits_fn(x).argmax(1)
    pred = torch.where(y == ignore_label, ignore_label, pred)
    inc = confusion_matrix(pred, y, num_classes=num_classes,
                           ignore_label=ignore_label)
    all_sum_([inc], group)
    return pred, hist + inc


def _stats(hist) -> EvalStats:
    _, macc, aacc = pixel_acc_from_hist(hist)
    _, miou = iou_from_hist(hist)
    return EvalStats(float(macc), float(aacc), float(miou))


def eval_performance(logits_fn: Callable, batches: Iterable, *,
                     num_classes: int, ignore_label: int = -1,
                     n_batches: int = -1, batch_size: Optional[int] = None,
                     return_preds: bool = True,
                     device: torch.device = torch.device("cpu"),
                     group: Optional[DataGroup] = None):
    """Clean/adv evaluation: stats and the ignore-masked argmax predictions
    (parity ``tools/infer.py:56-133``); under ``group`` each rank
    evaluates its rows, and the stats and predictions are the whole
    batch's on every rank."""
    hist = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                       device=device)
    preds_out: List[np.ndarray] = []
    for i, (x, y) in enumerate(batches):
        x, y = _to_device(x, y, device)
        if batch_size is None:
            batch_size = _static_batch_size(x.shape[0], group)
        x, y, n_real = _pad_batch(x, y, batch_size)
        pred, hist = _eval_step(logits_fn, shard_batch(x, group),
                                shard_batch(y, group), hist,
                                num_classes=num_classes,
                                ignore_label=ignore_label, group=group)
        if return_preds:
            preds_out.append(gather_rows(
                pred.cpu().numpy().astype(PRED_DTYPE), group)[:n_real])
        if i + 1 == n_batches:
            break
    stats = _stats(hist)
    return stats, np.concatenate(preds_out) if preds_out else None


def run_attack_over_loader(logits_fn: Callable, batches: Iterable, *,
                           loss: str, eps: float, n_iter: int = 300,
                           norm: str = "Linf",
                           weights: Optional[np.ndarray] = None,
                           track_loss: str = "ce-avg",
                           early_stop: bool = True, use_rs: bool = True,
                           n_batches: int = -1, seed: int = 0,
                           verbose: bool = False,
                           device: torch.device = torch.device("cpu"),
                           group: Optional[DataGroup] = None):
    """Attack every batch with ``apgd_largereps``; returns a list of
    ``(x_adv, y)`` numpy pairs (parity
    ``robseg_tpu.attacks.sea.run_attack_over_loader``; ``group`` for its
    ``mesh``: every rank returns the whole list). The random starts draw
    from one ``torch.Generator(device)`` seeded with ``seed``, batch after
    batch. ``apgd_largereps`` projects between its phases in Linf only, so
    another ``norm`` raises, as in the JAX package."""
    w = (torch.as_tensor(weights, device=device) if weights is not None
         else None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    batch_size = None
    for i, (x, y) in enumerate(batches):
        x_p, y_p = _to_device(x, y, device)
        if batch_size is None:
            first = x_p.shape[0]
            batch_size = _static_batch_size(first, group)
        x_p, y_p, n_real = _pad_batch(x_p, y_p, batch_size)
        x_adv = apgd_largereps(
            logits_fn, x_p, y_p, weights=w, norm=norm, eps=eps,
            n_iter=n_iter, loss=loss, early_stop=early_stop,
            track_loss=track_loss, use_rs=use_rs, generator=gen,
            group=group, draw_rows=first)[0]
        x_adv = gather_rows(x_adv.cpu().numpy(), group)[:n_real]
        if verbose and is_main(group):
            print(f"batch {i}: " + check_imgs(
                x_adv, x_p[:n_real].cpu().numpy(), norm))
        out.append((x_adv, y_p[:n_real].cpu().numpy()))
        if i + 1 == n_batches:
            break
    return out


def _load_cached(path: str) -> Dict[str, np.ndarray]:
    """What ``run_sea`` reads back of a finished attack's ``.npz`` (not
    its predictions)."""
    with np.load(path) as data:
        return {k: data[k] for k in ("mAcc", "aAcc", "mIoU", "ints", "unis",
                                     "accs")}


def run_sea(logits_fn: Callable, make_loader: Callable[[], Iterable], *,
            num_classes: int, eps: float, n_iter: int = 300,
            weights: Optional[np.ndarray] = None, n_batches: int = -1,
            losses: Sequence[str] = SEA_LOSSES, seed: int = 225,
            verbose: bool = False, resume_dir: Optional[str] = None,
            cache_tag: str = "", wc_engine: str = "auto",
            use_rs: bool = True, early_stop: bool = True,
            track_loss: str = "ce-avg", norm: str = "Linf",
            device: torch.device = torch.device("cpu"),
            group: Optional[DataGroup] = None) -> Dict:
    """Full SEA evaluation; parity ``robseg_tpu.attacks.sea.run_sea``.

    ``make_loader`` returns a fresh iterable of batches. ``resume_dir``
    keeps each finished attack's predictions and aggregation inputs as
    ``argmax_<tag>_<loss>_<eps>_<n_iter>.npz`` and skips attacks already
    there; ``cache_tag`` should identify the checkpoint. The random start
    of loss ``li`` draws from ``torch.Generator(device)`` seeded with
    ``seed + li``. ``group`` (``--shard``): see the module's docstring;
    every rank returns the same result.
    """
    main = is_main(group)
    clean_stats, _ = eval_performance(
        logits_fn, make_loader(), num_classes=num_classes,
        n_batches=n_batches, return_preds=False, device=device, group=group)
    if verbose and main:
        print(f"Clean performance: {clean_stats.as_dict()}")

    w = (torch.as_tensor(weights, device=device) if weights is not None
         else None)
    per_loss_stats: List[Dict] = []
    all_ints: List[np.ndarray] = []   # per loss: (N, K)
    all_unis: List[np.ndarray] = []
    all_accs: List[np.ndarray] = []   # per loss: (N,) per-image aAcc
    for li, loss in enumerate(losses):
        cache_path = None
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            tag = f"{cache_tag}_" if cache_tag else ""
            cache_path = os.path.join(
                resume_dir, f"argmax_{tag}{loss}_{eps:.6f}_{n_iter}.npz")
        # rank 0's file: every rank skips the same attacks with the same
        # inputs, whatever disk it has
        data = broadcast_object(
            _load_cached(cache_path) if cache_path and main
            and os.path.exists(cache_path) else None, group)
        if data is not None:
            per_loss_stats.append(
                {k: float(data[k]) for k in ("mAcc", "aAcc", "mIoU")})
            all_ints.append(data["ints"])
            all_unis.append(data["unis"])
            all_accs.append(data["accs"])
            if verbose and main:
                print(f"{loss}: resumed from {cache_path}")
            continue

        t0 = time.time()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + li)
        hist = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                           device=device)
        preds_l: List[np.ndarray] = []
        tgts_l: List[np.ndarray] = []
        ints_l: List[np.ndarray] = []
        unis_l: List[np.ndarray] = []
        accs_l: List[np.ndarray] = []
        batch_size = None
        for bi, (x, y) in enumerate(make_loader()):
            x_p, y_p = _to_device(x, y, device)
            if batch_size is None:
                first = x_p.shape[0]
                batch_size = _static_batch_size(first, group)
            x_p, y_p, n_real = _pad_batch(x_p, y_p, batch_size)
            x_adv = apgd_largereps(
                logits_fn, x_p, y_p, weights=w, norm=norm, eps=eps,
                n_iter=n_iter, loss=loss, early_stop=early_stop,
                track_loss=track_loss, use_rs=use_rs, generator=gen,
                group=group, draw_rows=first)[0]
            ys = shard_batch(y_p, group)
            if verbose:
                real = _real_rows(n_real, group, batch_size)
                line = _check_shards(x_adv[real],
                                     shard_batch(x_p, group)[real], norm,
                                     group)
                if main:
                    print(f"batch {bi}: {line}")
            pred, hist = _eval_step(logits_fn, x_adv, ys, hist,
                                    num_classes=num_classes, group=group)
            i_, u_ = per_image_intersect_union(pred, ys,
                                               num_classes=num_classes)
            a_ = per_image_pixel_acc(pred, ys)
            rows = gather_rows((pred.cpu().numpy().astype(PRED_DTYPE),
                                i_.cpu().numpy(), u_.cpu().numpy(),
                                a_.cpu().numpy()), group)
            for acc_l, r in zip((preds_l, ints_l, unis_l, accs_l), rows):
                acc_l.append(r[:n_real])
            tgts_l.append(y_p[:n_real].cpu().numpy().astype(PRED_DTYPE))
            if bi + 1 == n_batches:
                break
        stats = _stats(hist)
        per_loss_stats.append(stats.as_dict())
        all_ints.append(np.concatenate(ints_l))
        all_unis.append(np.concatenate(unis_l))
        all_accs.append(np.concatenate(accs_l))
        if cache_path and main:
            np.savez_compressed(cache_path, preds=np.concatenate(preds_l),
                                targets=np.concatenate(tgts_l),
                                ints=all_ints[-1], unis=all_unis[-1],
                                accs=all_accs[-1],
                                **{k: np.float64(v)
                                   for k, v in stats.as_dict().items()})
        if verbose and main:
            print(f"{loss}: {stats.as_dict()} ({time.time() - t0:.1f}s)")

    acc_mat = np.stack(all_accs)               # (A, N)
    worst_aacc = float(acc_mat.min(0).mean())
    per_attack_aacc = acc_mat.mean(-1)
    ints = np.stack(all_ints).astype(np.float64)
    unis = np.stack(all_unis).astype(np.float64)
    final_miou = worst_case_miou(ints, unis, seed=seed, engine=wc_engine)

    return {
        "seed": seed,
        "clean": clean_stats.as_dict(),
        "worst_Acc": worst_aacc,
        "worst_Acc_indiv": per_attack_aacc.tolist(),
        "final_miou": final_miou,
        "loss-wise_miou": [s["mIoU"] for s in per_loss_stats],
        "loss-wise_stats": per_loss_stats,
    }


def evaluate(logits_fn: Callable, batches: Iterable, *, num_classes: int,
             ignore_label: int = -1, n_batches: int = -1,
             device: torch.device = torch.device("cpu")):
    """Reference-shaped eval API: ``(cla_acc, macc, aacc, f1, mf1, ious,
    miou)`` like ``semseg/val.py:14-32``."""
    hist = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                       device=device)
    for i, (x, y) in enumerate(batches):
        x, y = _to_device(x, y, device)
        _, hist = _eval_step(logits_fn, x, y, hist, num_classes=num_classes,
                             ignore_label=ignore_label)
        if i + 1 == n_batches:
            break
    acc, macc, aacc = pixel_acc_from_hist(hist)
    f1, mf1 = f1_from_hist(hist)
    ious, miou = iou_from_hist(hist)
    return (acc.cpu().numpy(), float(macc), float(aacc), f1.cpu().numpy(),
            float(mf1), ious.cpu().numpy(), float(miou))
