"""sea_attack: SEA's Linf attack as ``robseg_torch/attacks/sea.py`` runs it,
batch after batch, on one model configuration.

Set-up makes the weights and ``traffic.batches`` batches of images from the
seed, labels them with the reference's clean argmax, with blocks of ignored
pixels, builds the program's model and ``ModelBundle``, and warms up every
shape of the window: a short attack of each loss and the scoring. Then the
window runs batch ``j`` through ``robseg_torch.attacks.apgd.apgd_largereps``
with loss ``traffic.losses[j % 3]`` and ``run_attack_over_loader``'s
arguments (Linf, ``n_iter`` 300 in phases of 90/90/120, ce-avg tracking, a
random start from the loss's own generator, early stop as the traffic sets
it), then scores the adversarial batch as ``run_sea`` does: argmax,
``iou_acc_summary`` and ``per_image_intersect_union`` (the confusion
kernel), host copies. The batches repeat once each has been attacked.

The harness's own wrapper of ``logits_fn`` marks every model call on the
device's timeline and ends the window at the first call after the deadline;
a wrapper of the APGD module's step records sampled steps. After the window
the reference follows the program from its own state at sampled calls (the
input gradient of the loss on every image, with the pixels the program
classifies correctly as the masked losses' mask; the gap of the program's
argmax below the reference's best logit, averaged over every pixel), at sampled steps (the Linf step and its
projection, on sampled images), and judges every finished batch (its
perturbation against the eps ball, its predictions against the reference's
logits, its counts and summary against counts of the same predictions) and
each batch's first input against the first phase's ball.

The control (``--control``) runs the program's own path of the precision
below the configuration's (the workload's ``control.precision``) in the
program's place; everything else, the step kernel too, stays as it is.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from portbench import flops, inputs
from portbench.compare import over
from portbench.reference import attack as ref_attack
from portbench.reference import metrics as ref_metrics
from portbench.reference import nets, strict
from portbench.trace import Observation, Slice, reduce_trace
from portbench.window import Outcome, Window, WindowClosed, percentile


class Probe:
    """The wrapper of ``logits_fn`` and of the APGD step: marks each model
    call, starts and stops the traced slice, and keeps clones of the sampled
    calls' inputs, predictions and input gradients, and of the sampled
    steps' inputs and outputs (sampled images only)."""

    def __init__(self, logits_fn, step_fn, window, plan):
        self.inner, self.step_fn = logits_fn, step_fn
        self.window, self.plan = window, plan
        self.calls = self.steps = 0
        self.loss = self.y = self.x = None
        self.call_records, self.step_records = [], []
        self.start_excess = []  # first input of each batch, beyond 2 eps
        self.first_call = False
        self.slice = None
        self.call_loss = []

    def logits_fn(self, x):
        w = self.window
        if not w.is_open:
            return self.inner(x)
        w.tick()
        k = self.calls
        self.calls += 1
        self.call_loss.append(self.loss)
        if self.slice is not None:
            if k == self.plan["trace_start"]:
                self.slice.start()
            elif k == self.plan["trace_start"] + self.plan["trace_calls"]:
                self.slice.stop()
        if self.first_call:
            self.first_call = False
            self.start_excess.append(
                ((x.detach() - self.x).abs().amax() - 2 * self.eps).float())
        out = self.inner(x)
        if k in self.plan["calls"]:
            rec = {"loss": self.loss, "x": x.detach().clone(),
                   "y": self.y,
                   "pred": out.detach().argmax(1).to(torch.int16)}
            if x.requires_grad:
                x.register_hook(lambda g: rec.__setitem__("grad", g.clone()))
            self.call_records.append(rec)
        return out

    def step(self, x, x_adv, x_old, grad, step, eps, a):
        out = self.step_fn(x, x_adv, x_old, grad, step, eps, a)
        if self.window.is_open:
            k = self.steps
            self.steps += 1
            if k in self.plan["steps"]:
                idx = self.plan["images"]
                self.step_records.append(
                    {"args": [t[idx].clone() for t in
                              (x, x_adv, x_old, grad, step.reshape(-1))],
                     "eps": eps, "a": a, "out": out[idx].clone()})
        return out


def _plan(seed: int, wl: dict, batch: int) -> dict:
    chk, tr = wl["check"], wl["trace"]
    rng = random.Random(inputs.sub_seed(seed, "check"))
    return {"calls": set(rng.sample(range(*chk["call_range"]),
                                    chk["model_calls"])),
            "steps": set(rng.sample(range(*chk["call_range"]),
                                    chk["steps"])),
            "images": sorted(rng.sample(range(batch), chk["images"])),
            "trace_start": tr["start"], "trace_calls": tr["calls"]}


def _labels(cfg, sd, xs, seed, share, dev):
    """The reference's clean argmax of each batch, blocks ignored."""
    with torch.device("meta"):
        ref = nets.build(cfg)
    ref = ref.to_empty(device=dev)
    ref.load_state_dict(sd)
    ref.eval().requires_grad_(False)
    ys = []
    with strict(), torch.no_grad():
        for j, x in enumerate(xs):
            y = torch.cat([ref(c).argmax(1) for c in x.split(4)])
            ign = inputs.ignore_mask(seed, f"sea.ignore.{j}", x.shape[0],
                                     x.shape[-2:], share, dev)
            ys.append(torch.where(ign, -1, y))
    return ys


def run(ctx) -> Outcome:
    cfg, wl, dev, seed = ctx.cfg, ctx.workload, ctx.device, ctx.seed
    tr = wl["traffic"]
    import robseg_torch.attacks.apgd as apgd_mod
    from robseg_torch.attacks.apgd import apgd_largereps
    from robseg_torch.attacks.sea import SEA_LOSSES
    from robseg_torch.infer import set_numerics
    from robseg_torch.models import ModelBundle, build_model
    from robseg_torch.ops.metrics import (iou_acc_summary,
                                          per_image_intersect_union)
    if any(loss not in SEA_LOSSES for loss in tr["losses"]):
        raise ValueError(f"traffic losses {tr['losses']}: not SEA's")
    set_numerics()
    b, hw, k = tr["batch"], tuple(tr["hw"]), cfg["n_cls"]
    eps = tr["eps"] / 255.0
    sd = inputs.state_dict(cfg, seed, dev)
    xs = [inputs.images(seed, f"sea.{j}", b, hw, dev)
          for j in range(tr["batches"])]
    ys = _labels(cfg, sd, xs, seed, tr["ignore_share"], dev)
    weights = torch.tensor(cfg["class_weights"], device=dev)
    flops_call = flops.attack_pass(cfg, b, hw) * b

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        module = build_model(cfg["model"]["name"], cfg["model"]["backbone"],
                             k, image_size=tuple(cfg["image_size"]))
    module = module.to_empty(device=dev)
    module.load_state_dict(sd)
    bundle = ModelBundle(module, wl["control"]["precision"] if ctx.control
                         else cfg["precision"])
    logits_fn = bundle.logits_fn
    program_step = apgd_mod.apgd_linf_step
    program_img_loss = apgd_mod.pixel_to_img_loss
    step_fn = program_step
    if ctx.fault == "unchanged":
        def step_fn(x, x_adv, x_old, grad, step, eps, a):
            return x_adv
    elif ctx.fault == "half_batch":
        def half(loss, mask=None):
            v = program_img_loss(loss, mask)
            return v * (torch.arange(v.shape[0], device=v.device)
                        < v.shape[0] // 2)
        apgd_mod.pixel_to_img_loss = half
    window = Window(dev, ctx.seconds)
    plan = _plan(seed, wl, b)
    probe = Probe(logits_fn, step_fn, window, plan)
    probe.eps = eps
    if ctx.trace:
        probe.slice = Slice(dev)
    gens = {loss: inputs.generator(seed, f"sea.rs.{loss}", dev)
            for loss in tr["losses"]}

    def attack(x, y, loss, n_iter):
        probe.loss, probe.x, probe.y = loss, x, y
        probe.first_call = True
        x_adv = apgd_largereps(
            probe.logits_fn, x, y, weights=weights, norm="Linf", eps=eps,
            n_iter=n_iter, loss=loss, early_stop=tr["early_stop"],
            track_loss="ce-avg",
            use_rs=True, generator=gens[loss], draw_rows=b)[0]
        if ctx.fault == "altered":  # one value of the answer moved to
            x_adv = x_adv.clone()   # the far end of the image box
            x_adv[0, 0, 0, 0] = (x[0, 0, 0, 0] < 0.5).to(x_adv.dtype)
        return x_adv

    def score(x_adv, y):
        with torch.no_grad():
            raw = logits_fn(x_adv).argmax(1)
        pred = torch.where(y == -1, -1, raw)
        summ = iou_acc_summary(pred, y, num_classes=k)
        ints, unis = per_image_intersect_union(pred, y, num_classes=k)
        return {"x_adv": x_adv.cpu(), "raw": raw.to(torch.int16).cpu(),
                "pred": pred.to(torch.int16).cpu(), "ints": ints.cpu(),
                "unis": unis.cpu(), "summary": [float(v) for v in summ]}

    finished, started = [], 0
    apgd_mod.apgd_linf_step = probe.step
    try:
        for loss in tr["losses"]:  # every shape and path of the window
            score(attack(xs[0], ys[0], loss, tr["warmup_iters"]), ys[0])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx.t0
        window.open()
        try:
            for j in range(10 ** 9):
                x, y = xs[j % len(xs)], ys[j % len(ys)]
                loss = tr["losses"][j % len(tr["losses"])]
                started += 1
                calls0 = probe.calls
                x_adv = attack(x, y, loss, tr["n_iter"])
                rec = score(x_adv, y)
                rec.update(j=j, loss=loss, calls=probe.calls - calls0)
                finished.append(rec)
        except WindowClosed:
            pass
    finally:
        apgd_mod.apgd_linf_step = program_step
        apgd_mod.pixel_to_img_loss = program_img_loss
    intervals = window.intervals_ms()
    values = {"attack_rate": window.units * b / window.length_s,
              "attack_iter_ms.p95": percentile(intervals, 95),
              "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    notes = [f"window {window.length_s:.3f} s, {window.units} model calls "
             f"of {b} images, {len(finished)} batches finished of "
             f"{started} started; iterations run / scheduled per finished "
             f"batch: " + ", ".join(
                 f"{r['loss']} {r['calls']}/{tr['n_iter'] + 3}"
                 for r in finished),
             f"attack_iter_ms p50 {percentile(intervals, 50):.3f}, "
             f"intervals {len(intervals)}; longest (ms after call, loss): "
             + ", ".join(f"{v:.1f} after {i} {probe.call_loss[i]}"
                         for v, i in sorted(((v, i) for i, v in
                                             enumerate(intervals)),
                                            reverse=True)[:8])]
    obs = None
    if ctx.trace and probe.slice.done:
        ops, win_s, busy_s = reduce_trace(probe.slice.events())
        obs = Observation(ops, win_s, busy_s, plan["trace_calls"],
                          flops_call, cfg, wl, intervals,
                          {"window_units": window.units,
                           "window_s": window.length_s})

    # the program's state goes before the reference runs
    start_excess = [float(v) for v in probe.start_excess]
    calls, steps = probe.call_records, probe.step_records
    del probe, bundle, module, logits_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cfg, sd, xs, ys, weights, eps, calls, steps, finished,
                     start_excess, wl["limits"], dev)
    failed = sum(b for r in finished
                 if not torch.isfinite(r["x_adv"]).all())
    return Outcome(started * b, failed, values, checks, peak, obs, notes)


def compare(cfg, sd, xs, ys, weights, eps, calls, steps, finished,
            start_excess, limits, dev):
    """The reference against what the program produced; one (name, value,
    limit) per number compared."""
    k = cfg["n_cls"]
    with torch.device("meta"):
        ref = nets.build(cfg)
    ref = ref.to_empty(device=dev)
    ref.load_state_dict(sd)
    ref.eval().requires_grad_(False)
    out = {}
    with strict():
        # the program's state at a sampled call: its input, and which
        # pixels it classifies correctly (the masked losses' mask); the
        # mask's own stage is judged by the gap of its argmax below the
        # reference's best, summed with the pixels it covers
        gaps = [0.0, 0]
        pool = [0.0, 0.0]
        for r in calls:
            for c in range(0, r["x"].shape[0], 4):
                sl = slice(c, c + 4)
                pred = r["pred"][sl].long()
                lr, gr = ref_attack.loss_input_grad(
                    ref, r["x"][sl], r["y"][sl], r["loss"], weights,
                    correct=(pred == r["y"][sl]) & (r["y"][sl] != -1))
                d = lr.amax(1) - lr.gather(1, pred[:, None])[:, 0]
                gaps[0] += float(d.double().sum())
                gaps[1] += d.numel()
                if "grad" in r:
                    gp = r["grad"][sl]
                    pool[0] += float((gp - gr).pow(2).sum())
                    pool[1] += float(gr.pow(2).sum())
        # the relative L2 error over every image of every sampled call
        out["grad_rel_err"] = over(pool[0], pool[1]) ** 0.5
        step_err = 0.0
        for r in steps:
            want = ref_attack.apgd_linf_step(*r["args"], r["eps"], r["a"])
            step_err = max(step_err, float((r["out"] - want).abs().max()))
        out["step_abs_err"] = step_err
        ball, counts, summ = list(start_excess), 0.0, 0.0
        for r in finished:
            x, y = xs[r["j"] % len(xs)], ys[r["j"] % len(ys)]
            x_adv = r["x_adv"].to(dev)
            ball.append(float(torch.stack([
                (x_adv - x).abs().amax() - eps, -x_adv.amin(),
                x_adv.amax() - 1.0]).amax()))
            raw = r["raw"].to(dev).long()
            with torch.no_grad():
                for c in range(0, x.shape[0], 4):
                    lr = ref(x_adv[c:c + 4])
                    d = lr.amax(1) - lr.gather(1, raw[c:c + 4, None])[:, 0]
                    gaps[0] += float(d.double().sum())
                    gaps[1] += d.numel()
            inter, union, hist = ref_metrics.per_image_counts(
                r["pred"].to(dev).long(), y, k)
            counts = max(counts,
                         float((r["ints"].to(dev) - inter).abs().max()),
                         float((r["unis"].to(dev) - union).abs().max()))
            summ = max(summ, max(abs(a - b) for a, b in zip(
                r["summary"], ref_metrics.summary(hist))))
        out["ball_excess"] = max(ball, default=0.0)
        # the mean over every pixel compared: a pixel counts where the
        # program's argmax is not the reference's, by the gap there, so the
        # mean grows as the square of the program's error
        out["pred_logit_gap_mean"] = over(gaps[0], gaps[1])
        out["count_err"] = counts
        out["summary_err"] = summ
    return [(name, value, limits.get(name)) for name, value in out.items()]
