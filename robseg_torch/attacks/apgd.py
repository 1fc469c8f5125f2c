"""APGD for semantic segmentation: Linf, L2 and L1.

Port of ``robseg_tpu/attacks/apgd.py``: ``_apgd_core`` as a Python loop
over the same state (``:50-68``), ``apgd_attack``, ``apgd_largereps``,
``targeted_classes`` and ``apgd_restarts``. The Linf step (``:371-375``)
is the APGD step kernel (``kernels/apgd_step.py``); the L2 and L1 steps
(``:376-396``) are plain PyTorch, as the JAX package leaves them to XLA
outside any Pallas kernel. All per-image bookkeeping stays on the device
as tensor operations: the best points, the loss history, the oscillation
check, the step halving and (L1) the sparsity controller (``:439-455``).
The loop counters (``i``, ``counter3``, ``k``) depend on nothing but
``n_iter``, so they are Python ints; the one host sync per iteration is
the early-stop test ``acc.sum() > 0``. Under data parallelism
(``group``, ``make_sharded_apgd``'s ``psum``-ed early stop, ``:170``)
each rank attacks its shard of the batch and that sum is all-reduced
before the sync, so every rank stops at the iteration the whole batch
stops at, and per-image results equal the one-process run's.

Semantics notes (as in the JAX core):
  * best-point and step-size logic use the tracking loss (``ce-avg`` for
    SEA), not the attack loss;
  * ignored pixels count as correct in the accuracy that picks
    ``x_best_adv`` but not in the first accuracy;
  * the oscillation check reads the loss history with torch's
    negative-index wrap at the first check (modular indexing);
  * ``eps`` is carried as a float32 scalar, as the JAX core carries it;
  * the random start is Linf only, and ``apgd_largereps`` projects
    between its phases in Linf only: both raise otherwise, as in JAX.

Left out: the XLA machinery (``closure_to_args``; the per-device
program ``make_sharded_apgd`` compiles is the ``group`` argument here).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robseg_torch.kernels.apgd_step import apgd_linf_step
from robseg_torch.ops.losses import ATTACK_CRITERIA, pixel_to_img_loss
from robseg_torch.ops.projections import (_l2_norm, project_l1_ball_box,
                                          project_l2)
from robseg_torch.parallel import DataGroup, all_sum_, shard_batch


class APGDResult(NamedTuple):
    x_best: torch.Tensor      # best-tracking-loss points
    acc: torch.Tensor         # per-image pixel accuracy of best adv found
    loss_best: torch.Tensor   # per-image best tracking loss
    x_best_adv: torch.Tensor  # lowest-pixel-accuracy points (the SEA output)


def _per_image_acc(logits, y, ignore_index: int,
                   count_ignored_correct: bool) -> torch.Tensor:
    correct = logits.argmax(1) == y
    if count_ignored_correct:
        correct = correct | (y == ignore_index)
    return correct.reshape(correct.shape[0], -1).to(torch.float32).mean(-1)


def _apgd_ctrl(norm: str, n_iter: int) -> dict:
    """Step-size controller constants with the reference's exact
    int()-of-float arithmetic (``attacker.py:323-337``)."""
    if norm in ("Linf", "L2"):
        ctrl = dict(n_iter=n_iter,
                    n_iter_2=max(int(0.22 * n_iter), 1),
                    n_iter_min=max(int(0.06 * n_iter), 1),
                    size_decr=max(int(0.03 * n_iter), 1))
        ctrl["k0"] = ctrl["n_iter_2"]
    elif norm == "L1":
        ctrl = dict(n_iter=n_iter, n_iter_2=1, n_iter_min=1, size_decr=1,
                    k0=max(int(0.04 * n_iter), 1))
    else:
        raise ValueError(norm)
    return ctrl


def _bimg(v: torch.Tensor, ndims: int) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1) broadcast helper."""
    return v.reshape(v.shape + (1,) * ndims)


def apgd_attack(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                norm: str = "Linf", eps: float, n_iter: int = 10,
                use_rs: bool = False, loss: str = "ce",
                track_loss: Optional[str] = None, early_stop: bool = False,
                is_train: bool = False, ignore_index: int = -1,
                weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                x_init: Optional[torch.Tensor] = None,
                y_target: Optional[torch.Tensor] = None,
                n_iter_buf: Optional[int] = None,
                group: Optional[DataGroup] = None) -> APGDResult:
    """One APGD run; parity ``robseg_tpu.attacks.apgd.apgd_attack``.

    ``x`` (B, 3, H, W) in [0, 1], ``y`` (B, H, W) int64. ``norm`` is
    ``Linf``, ``L2`` or ``L1``. ``generator`` draws the random start
    (``use_rs``, Linf only) on ``x``'s device. ``y_target`` (B, H, W): the
    labels the attack loss reads (a targeted loss), while accuracy and
    the tracking loss read ``y``. ``is_train`` sets the L1 attack's first
    sparsity (0.05, else 0.2). ``n_iter_buf`` sizes the loss history
    (defaults to ``n_iter``). ``group``: ``x`` and ``y`` are this rank's
    shard of the batch, and the early stop is decided over all ranks.
    """
    if ignore_index != -1:
        raise ValueError("Only ignore_index = -1 is supported.")
    if n_iter_buf is None:
        n_iter_buf = n_iter
    if n_iter > n_iter_buf:
        raise ValueError(f"n_iter {n_iter} > n_iter_buf {n_iter_buf}")
    ctrl = _apgd_ctrl(norm, n_iter)
    eps = float(np.float32(eps))
    with torch.no_grad():
        return _apgd_core(logits_fn, x, y, x_init, eps, ctrl, weights,
                          generator, y_target, norm=norm, use_rs=use_rs,
                          loss=loss, track_loss=track_loss,
                          early_stop=early_stop, is_train=is_train,
                          ignore_index=ignore_index, n_iter_buf=n_iter_buf,
                          group=group)


def _random_start(x: torch.Tensor, eps: float, norm: str, generator,
                  draw_rows: Optional[int] = None) -> torch.Tensor:
    """The uniform Linf random start in the ``eps`` ball, drawn from
    ``generator`` for the first ``draw_rows`` rows of ``x`` (all of them
    by default); the rows after those start at ``x``."""
    if norm != "Linf":
        raise NotImplementedError("random start only for Linf (parity)")
    n = x.shape[0] if draw_rows is None else draw_rows
    t = 2.0 * torch.rand((n,) + x.shape[1:], generator=generator,
                         device=x.device, dtype=x.dtype) - 1.0
    if n < x.shape[0]:
        t = torch.cat([t, t.new_zeros((x.shape[0] - n,) + x.shape[1:])])
    return torch.clamp(x + eps * t, 0.0, 1.0)


def _none_correct(acc: torch.Tensor, group: Optional[DataGroup]) -> bool:
    """Every image of the batch at zero accuracy: the early stop. One host
    sync; over all ranks' shards under ``group``."""
    total = acc.sum()
    all_sum_([total], group)
    return total.item() == 0


def _apgd_core(logits_fn, x, y, x_init, eps: float, ctrl: dict, weights,
               generator, y_target, *, norm: str, use_rs: bool, loss: str,
               track_loss: Optional[str], early_stop: bool, is_train: bool,
               ignore_index: int, n_iter_buf: int,
               group: Optional[DataGroup] = None) -> APGDResult:
    bs = x.shape[0]
    ndims = x.ndim - 1
    n_fts = x.numel() // bs
    criterion = ATTACK_CRITERIA[loss]
    track_fn = ATTACK_CRITERIA[track_loss or loss]
    n_iter = ctrl["n_iter"]
    mask_background = (y != ignore_index).to(x.dtype)
    y_loss = y_target if y_target is not None else y

    # --- init point -------------------------------------------------------
    if x_init is not None:
        x_adv = x_init
    elif use_rs:
        x_adv = _random_start(x, eps, norm, generator)
    else:
        x_adv = x
    x_adv = torch.clamp(x_adv, 0.0, 1.0)

    # --- hyper-parameters (attacker.py:322-339) ---------------------------
    if norm in ("Linf", "L2"):
        thr_decr = 0.75
        alpha = 2.0
        k_max = max(int(0.22 * n_iter_buf), 1)
    else:  # L1
        init_topk = 0.05 if is_train else 0.2
        adasp_redstep, adasp_minstep = 1.5, 10.0
        alpha = 1.0
        # the JAX core's float32 scalars: alpha * eps and its tenth
        step_max = float(np.float32(alpha) * np.float32(eps))
        step_min = float(np.float32(step_max) / np.float32(adasp_minstep))
    n_iter_min, size_decr = ctrl["n_iter_min"], ctrl["size_decr"]

    def loss_grad(xa):
        with torch.enable_grad():
            xa = xa.detach().requires_grad_(True)
            logits = logits_fn(xa)
            li = criterion(logits, y_loss, weights)
            total = pixel_to_img_loss(li, mask_background).sum()
            (grad,) = torch.autograd.grad(total, xa)
        logits = logits.detach()
        track_i = pixel_to_img_loss(track_fn(logits, y, None),
                                    mask_background)
        return logits, grad, track_i

    logits, grad, loss_best = loss_grad(x_adv)
    acc = _per_image_acc(logits, y, ignore_index, count_ignored_correct=False)
    x_adv_old = x_adv
    x_best, grad_best, x_best_adv = x_adv, grad, x_adv
    loss_best_last_check = loss_best
    reduced_last_check = torch.ones((bs,), dtype=torch.float32,
                                    device=x.device)
    step_size = torch.full((bs,) + (1,) * ndims, alpha * eps, dtype=x.dtype,
                           device=x.device)
    loss_steps = torch.zeros((n_iter_buf, bs), dtype=loss_best.dtype,
                             device=x.device)
    if norm == "L1":
        topk = torch.full((bs,), init_topk, dtype=torch.float32,
                          device=x.device)
        sp_old = torch.full((bs,), float(n_fts), dtype=torch.float32,
                            device=x.device)
    counter3 = 0
    k = ctrl["k0"]

    i = 0
    while i < n_iter and not (early_stop and _none_correct(acc, group)):
        a = 0.75 if i > 0 else 1.0
        if norm == "Linf":
            x_next = apgd_linf_step(x, x_adv, x_adv_old, grad, step_size,
                                    eps, a)
        elif norm == "L2":
            grad2 = x_adv - x_adv_old
            z = x_adv + step_size * grad / (_l2_norm(grad) + 1e-12)
            z = project_l2(z, x, eps)
            x_next = project_l2(x_adv + (z - x_adv) * a + grad2 * (1.0 - a),
                                x, eps)
        else:  # L1: a sign step on the largest |grad| entries
            g_sorted = torch.sort(grad.abs().reshape(bs, -1), dim=-1).values
            topk_curr = torch.clamp((1.0 - topk) * n_fts, 0, n_fts - 1).to(
                torch.int64)
            thr = g_sorted.gather(1, topk_curr[:, None])
            sparsegrad = grad * (grad.abs() >= _bimg(thr[:, 0], ndims)).to(
                x.dtype)
            sg_sign = torch.sign(sparsegrad)
            denom = sg_sign.abs().reshape(bs, -1).sum(-1)
            x_next = x_adv + step_size * sg_sign / (_bimg(denom, ndims)
                                                    + 1e-10)
            delta_u = x_next - x
            x_next = x + delta_u + project_l1_ball_box(x, delta_u, eps)
        x_adv_old = x_adv
        x_adv = x_next
        logits, grad, y1 = loss_grad(x_adv)

        avg_acc = _per_image_acc(logits, y, ignore_index,
                                 count_ignored_correct=True)
        improved = avg_acc <= acc
        acc = torch.minimum(acc, avg_acc)
        x_best_adv = torch.where(_bimg(improved, ndims), x_adv, x_best_adv)

        loss_steps[i] = y1
        better = y1 > loss_best
        bet_b = _bimg(better, ndims)
        x_best = torch.where(bet_b, x_adv, x_best)
        grad_best = torch.where(bet_b, grad, grad_best)
        loss_best = torch.where(better, y1, loss_best)

        counter3 += 1
        if counter3 == k and norm == "L1":
            # sparsity adaptation (attacker.py:553-566)
            sp_curr = ((x_best - x).abs().reshape(bs, -1) > 0).sum(-1).to(
                torch.float32)
            fl_redtopk = (sp_curr / sp_old) < 0.95
            topk = sp_curr / n_fts / 1.5
            sp_old = sp_curr
            red_b = _bimg(fl_redtopk, ndims)
            step_size = torch.clamp(
                torch.where(red_b, step_max, step_size / adasp_redstep),
                step_min, step_max)
            x_adv = torch.where(red_b, x_best, x_adv)
            grad = torch.where(red_b, grad_best, grad)
            counter3 = 0
        elif counter3 == k:
            # oscillation check, parity attacker.py:243-248 (incl. the
            # negative-index wrap)
            offs = np.arange(k_max)
            idx1 = torch.as_tensor((i - offs) % n_iter, device=x.device)
            idx2 = torch.as_tensor((i - offs - 1) % n_iter, device=x.device)
            cmp = (loss_steps[idx1] > loss_steps[idx2]).to(torch.float32)
            mask = torch.as_tensor(offs < k, dtype=torch.float32,
                                   device=x.device)[:, None]
            fl_osc = ((cmp * mask).sum(0) <= k * thr_decr).to(torch.float32)
            fl_no_impr = (1.0 - reduced_last_check) * (
                loss_best_last_check >= loss_best).to(torch.float32)
            fl_osc = torch.maximum(fl_osc, fl_no_impr)
            reduced_last_check = fl_osc
            loss_best_last_check = loss_best
            halve = _bimg(fl_osc > 0, ndims)
            step_size = torch.where(halve, step_size / 2.0, step_size)
            x_adv = torch.where(halve, x_best, x_adv)
            grad = torch.where(halve, grad_best, grad)
            counter3 = 0
            k = max(k - size_decr, n_iter_min)
        i += 1

    return APGDResult(x_best, acc, loss_best, x_best_adv)


def _project_back(z: torch.Tensor, x: torch.Tensor, norm: str, eps: float
                  ) -> torch.Tensor:
    """Parity ``apgd_largereps._project`` (``attacker.py:683-690``); the
    JAX package has it for Linf only."""
    if norm != "Linf":
        raise NotImplementedError(norm)
    return torch.clamp(x + torch.clamp(z - x, -eps, eps), 0.0, 1.0)


def apgd_largereps(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                   weights: Optional[torch.Tensor] = None,
                   norm: str = "Linf", eps: float = 8.0 / 255.0,
                   n_iter: int = 10, loss: str = "ce",
                   early_stop: bool = False, track_loss: Optional[str] = None,
                   use_rs: bool = False, ignore_index: int = -1,
                   generator: Optional[torch.Generator] = None,
                   x_init: Optional[torch.Tensor] = None,
                   group: Optional[DataGroup] = None,
                   draw_rows: Optional[int] = None):
    """SEA per-loss attack: three warm-started phases at eps * (2, 1.5, 1)
    of 30/30/40% of ``n_iter``. Returns ``(x_adv, None, acc)``.

    ``group`` (``_make_attack_fn``'s sharded branch, ``sea.py:124-160``):
    ``x``, ``y`` and ``x_init`` are the whole (padded) batch; the random
    start is drawn over it, then every phase runs on this rank's rows, and
    ``x_adv`` and ``acc`` are those rows'. ``draw_rows``: draw the random
    start for the first ``draw_rows`` rows only (the batch the
    one-process run attacks; the padding starts at ``x``)."""
    n_iters = [int(0.3 * n_iter), int(0.3 * n_iter)]
    n_iters.append(n_iter - sum(n_iters))
    epss = [2.0 * eps, 1.5 * eps, 1.0 * eps]
    xs, ys = shard_batch(x, group), shard_batch(y, group)
    if x_init is not None:
        x_init = _project_back(shard_batch(x_init, group), xs, norm,
                               epss[0])
    elif use_rs:
        x_init = shard_batch(_random_start(x, float(np.float32(epss[0])),
                                           norm, generator, draw_rows),
                             group)
    acc = torch.ones((xs.shape[0],), dtype=torch.float32, device=x.device)
    for i, (it, ep) in enumerate(zip(n_iters, epss)):
        if i:
            x_init = _project_back(x_init, xs, norm, ep)
        res = apgd_attack(
            logits_fn, xs, ys, norm=norm, eps=ep, n_iter=it, loss=loss,
            track_loss=track_loss, early_stop=early_stop,
            ignore_index=ignore_index, weights=weights, x_init=x_init,
            n_iter_buf=max(n_iters), group=group)
        acc = res.acc
        x_init = res.x_best_adv
    return x_init, None, acc


def targeted_classes(clean_sorted: torch.Tensor, y: torch.Tensor,
                     restart_i: int, n_target_classes: int) -> torch.Tensor:
    """Per-pixel target class of targeted restart ``restart_i``
    (``attacker.py:607-620``): each pixel's
    ``(restart_i % n_target_classes + 1)``-th most probable clean class,
    or the next lower-ranked one where that is the true label.
    ``clean_sorted``: the ascending argsort of the clean logits over the
    class axis, ``(B, K, H, W)``."""
    n_cls = clean_sorted.shape[1]
    target_cls = restart_i % n_target_classes + 1
    y_target = clean_sorted[:, n_cls - target_cls]
    alt = clean_sorted[:, max(n_cls - target_cls - 1, 0)]
    return torch.where(y_target == y, alt, y_target)


def apgd_restarts(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                  norm: str = "Linf", eps: float = 8.0 / 255.0,
                  n_iter: int = 10, loss: str = "ce", n_restarts: int = 1,
                  early_stop: bool = False, track_loss: Optional[str] = None,
                  use_rs: bool = False, ignore_index: int = -1,
                  n_target_classes: int = 21,
                  generator: Optional[torch.Generator] = None):
    """APGD with restarts, keeping each image's lowest-accuracy point;
    parity ``robseg_tpu.attacks.apgd.apgd_restarts``
    (``attacker.py:574-659``). Every restart attacks the whole batch and
    the merge is masked. A ``loss`` with "targeted" in its name cycles the
    target classes over the restarts (``targeted_classes``). The random
    starts draw from ``generator`` in turn. Returns
    ``(x_adv, None, acc)``."""
    acc = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    x_adv = x
    ndims = x.ndim - 1
    targeted = "targeted" in loss
    if targeted:
        with torch.no_grad():
            clean_sorted = torch.argsort(logits_fn(x), dim=1, stable=True)
    for i in range(n_restarts):
        y_target = None
        if targeted:
            y_target = targeted_classes(clean_sorted, y, i, n_target_classes)
        res = apgd_attack(
            logits_fn, x, y, norm=norm, eps=eps, n_iter=n_iter,
            use_rs=use_rs, loss=loss, track_loss=track_loss,
            early_stop=early_stop, ignore_index=ignore_index,
            generator=generator, y_target=y_target)
        with torch.no_grad():
            logits = logits_fn(res.x_best_adv)
        acc_curr = _per_image_acc(logits, y, ignore_index,
                                  count_ignored_correct=True)
        to_update = (acc_curr < acc) & (acc > 0)
        x_adv = torch.where(_bimg(to_update, ndims), res.x_best_adv, x_adv)
        acc = torch.where(to_update, acc_curr, acc)
    return x_adv, None, acc
