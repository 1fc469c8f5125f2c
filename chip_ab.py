"""Two commits timed against each other on one card.

Runs parts of ``chip_smoke.py`` from each checkout given, in turn, each in
a process of its own that builds that checkout's kernels:

    python3 chip_ab.py [--what WHAT] [--out DIR] DIR [DIR ...]

``DIR`` is a checkout: the repository's root, or another commit unpacked
with ``git archive`` into a git-ignored directory. Give them in turns
(parent, change, change, parent): a card's clocks follow its power and
temperature, so one pair alone says little. ``WHAT``:

- ``kernels``: phases 2, 2 fpn, 2 mlp and 2b (every kernel against its
  plain version, with times, bounds and the per-kernel splits; the block
  forward's device split by kernel beside each kernel's bound);
- ``paths``: phases 4 and 4c (the main path's APGD rates under
  ``default`` and ``bf16``, each with its profile) and 10a (the train
  step);
- ``all``: both (the default);
- ``fpn``: the FPN GEMM's own time (torch.profiler) in the input gradient
  and the forward at the head's shape, batch 16, the float32 form on the
  bf16 form's values upcast, forms in turns f32, bf16, bf16, f32, the
  card's clock, power and temperature before and after each;
- ``steps``: 10a's fused-attack train step alone, ten timed steps after
  two, each step's time;
- ``confusion``: the confusion phase's cases and K = 716, the first K
  whose 16 per-image outputs pass 5/8 of an H100's L2 (random and blocky
  labels, summed and per image, batch 16 at 512^2), each
  exact against the plain version, timed by this script's own code in
  every checkout: a call (CUDA events around one call, the wrapper's host
  work included), back to back (20 calls between two events), and the
  device time of one call by torch.profiler, kernels and the memset that
  zeroes the output apart; with the bytes bound and torch.bincount;
- ``launch``: the wrappers' call time (CUDA events around one call, the
  wrapper's host work included; ROUNDS rounds of 20 calls, each round's
  median) of the APGD step (batch 16, 512^2, row 5 of PERF.md), the
  confusion kernel (K = 21, summed, random labels, row 6) and one
  stage-0 block forward (16 x 128 x 128 x 96, float32), with the host
  time of the launch guard's parts on the current card, each given the
  card as a device (``cuda:0``, as the wrappers did before the guard) and
  as its index (as ``_build.launch`` gives it): the current-stream query,
  ``torch.cuda.device`` entered and left, and both.

Each run's output goes to ``<out>/ab_<i>_<dir>_<what>.log`` (``--out``,
by default ``outputs/chip_ab``); the lines that compare are printed at
the end. Needs a card: exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SUMMARY = re.compile(
    r"four batch-16|^(block|fpn_concat_conv).*kernel [\d.]+ ms, plain"
    r"|^block .*fwd device split|^convnext_mlp .*3 stages summed"
    r"|apgd .*marginal|^train step \(|^fpn gemm|^steps"
    r"|^confusion ab |^launch ab ")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def fpn_turns(cs, dev):
    import torch
    from robseg_torch.kernels import fpn_conv as fc
    torch.manual_seed(0)
    n, shape, co = 4, (cs.BATCH, 128, 128, 512), 512
    xs = [torch.randn(shape, device=dev).to(torch.bfloat16)
          for _ in range(n)]
    w = (torch.randn((n, 3, 3, 512, co), device=dev) / 70).to(
        torch.bfloat16)
    s = 1 + 0.1 * torch.randn(co, device=dev)
    t = 0.1 * torch.randn(co, device=dev)
    out = fc.fpn_concat_conv_fwd_bf16_cuda(xs, w, s, t)
    dy = torch.randn(out.shape, device=dev).to(torch.bfloat16)
    case = {torch.bfloat16: (xs, w, out, dy),
            torch.float32: ([x.float() for x in xs], w.float(), out.float(),
                            dy.float())}
    for dt in (torch.float32, torch.bfloat16, torch.bfloat16,
               torch.float32):
        xs, w, out, dy = case[dt]
        before = smi("clocks.sm,power.draw,temperature.gpu")

        def gemm(fn):
            return [ms for name, ms, _ in cs.kernel_split(fn, 10)
                    if "fpn_gemm" in name][0]
        dx = gemm(lambda: fc._DX_CUDA[dt](dy, out, w, s))
        fwd = gemm(lambda: fc._FWD_CUDA[dt](xs, w, s, t))
        print(f"fpn gemm {str(dt)[6:]}: dx {dx:.4f} ms, fwd {fwd:.4f} ms "
              f"[{before} -> {smi('clocks.sm,power.draw,temperature.gpu')}]",
              flush=True)


ROUNDS = 5


def launch_turns(cs, dev):
    import numpy as np
    import torch
    from robseg_torch.kernels import apgd_step
    from robseg_torch.kernels import confusion as cf
    from robseg_torch.kernels import convnext_block as cb
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (cs.BATCH, 3, cs.HW, cs.HW)
    x = torch.rand(shape, device=dev, generator=g)
    x_adv, x_old = (torch.clamp(x + (torch.rand(shape, device=dev, generator=g)
                                     - 0.5) * cs.EPS, 0, 1) for _ in (0, 1))
    grad = torch.randn(shape, device=dev, generator=g)
    step = torch.rand((cs.BATCH, 1, 1, 1), device=dev, generator=g) * cs.EPS
    pred, tgt = cs.label_maps((cs.BATCH, cs.HW, cs.HW), cs.N_CLS, False, dev,
                              0)
    p = cs.block_params(np.random.default_rng(0), 96, dev)
    xb = torch.randn((cs.BATCH, 128, 128, 96), device=dev, generator=g)
    cases = (
        ("apgd_linf_step (16, 3, 512, 512)", lambda: apgd_step.
         apgd_linf_step_cuda(x, x_adv, x_old, grad, step, cs.EPS, 0.75)),
        ("confusion_matrix K=21 summed (16, 512, 512)",
         lambda: cf.confusion_matrix_cuda(pred, tgt, num_classes=cs.N_CLS)),
        ("convnext_block_fwd (16, 128, 128, 96)",
         lambda: cb.convnext_block_fwd_cuda(xb, *p)))
    for name, fn in cases:
        rounds = [cs.cuda_ms(fn, 20) for _ in range(ROUNDS)]
        print(f"launch ab {name}: call " + " ".join(
            f"{ms:.4f}" for ms in rounds) + f" ms, median "
            f"{float(np.median(rounds)):.4f}", flush=True)
    def stream(card):
        return torch.cuda.current_stream(card).cuda_stream

    def guard(card):
        with torch.cuda.device(card):
            pass

    def both(card):
        with torch.cuda.device(card):
            return stream(card)

    us = []
    for name, part, card in (
            (f"stream query by {xb.device}", stream, xb.device),
            ("by index", stream, xb.device.index),
            (f"device guard by {xb.device}", guard, xb.device),
            ("by index", guard, xb.device.index),
            (f"guard and query by {xb.device}", both, xb.device),
            ("by index", both, xb.device.index)):
        runs = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            for _ in range(10000):
                part(card)
            runs.append((time.perf_counter() - t0) / 10000 * 1e6)
        us.append(f"{name} " + " ".join(f"{v:.2f}" for v in runs))
    print(f"launch ab host us a call on {xb.device}, already current, "
          f"{ROUNDS} rounds of 10000: " + "; ".join(us), flush=True)


CONFUSION_KS = (21, 151, 239, 300, 459, 847, 673, 716)


def confusion_turns(cs, dev):
    import inspect

    import numpy as np
    import torch
    from robseg_torch.kernels import confusion as cf
    props = torch.cuda.get_device_properties(dev)
    # plan's card arguments: the SMs, and the L2 where the checkout's plan
    # takes it
    card = (props.multi_processor_count, props.L2_cache_size)
    if "l2_bytes" not in inspect.signature(cf.plan).parameters:
        card = card[:1]
    print(f"confusion ab plan's card arguments: {card}", flush=True)
    for seed, (k, blocky) in enumerate(
            (k, b) for k in CONFUSION_KS for b in (False, True)):
        pred, tgt = cs.label_maps((cs.BATCH, cs.HW, cs.HW), k, blocky, dev,
                                  seed)
        for per_image in (False, True):
            kw = dict(num_classes=k, per_image=per_image)
            rows, n = ((cs.BATCH, cs.HW * cs.HW) if per_image
                       else (1, cs.BATCH * cs.HW * cs.HW))
            launch = cf.plan(k, rows, n, *card)
            want = cf.confusion_matrix_plain(pred, tgt, **kw)
            if not torch.equal(cf.confusion_matrix_cuda(pred, tgt, **kw),
                               want):
                raise AssertionError(f"confusion K={k} differs from plain")
            fn = lambda: cf.confusion_matrix_cuda(pred, tgt, **kw)  # noqa
            call = cs.cuda_ms(fn, 20)
            for _ in range(3):
                fn()
            runs = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    fn()
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b) / 20)
            split = cs.kernel_split(fn, 10)
            kern = sum(ms for name, ms, _ in split if "confusion" in name)
            mem = sum(ms for name, ms, _ in split if "emset" in name)
            img = torch.arange(cs.BATCH, device=dev).view(cs.BATCH, 1, 1)
            idx = (tgt * k + pred + (img * k * k if per_image else 0))[
                tgt != -1]
            lib = cs.cuda_ms(lambda: torch.bincount(
                idx, minlength=want.numel()))
            bms = cs.bound(16 * tgt.numel() + 4 * want.numel(), {"f32": 0})[0]
            dev_ms = (kern + mem) if split else None
            print(f"confusion ab K={k} {'blocky' if blocky else 'random'} "
                  f"per_image={per_image} ({launch['form']}, grid "
                  f"{launch['grid']}): call {call:.4f} ms, "
                  f"back to back {float(np.median(runs)):.4f} ms, device "
                  f"{cs.fmt_ms(dev_ms)} (kernels {kern:.4f} + memset "
                  f"{mem:.4f}), bound {bms:.4f} ms, device share "
                  f"{cs.fmt_share(bms, dev_ms)}, torch.bincount {lib:.4f} ms",
                  flush=True)
        del pred, tgt


def train_steps(cs, dev):
    import torch
    from robseg_torch.utils.profiling import StepTimer
    x, y = cs.train_inputs(dev, cs.TRAIN_BATCH, cs.TRAIN_HW, cs.N_CLS)
    trainer = cs.upernet_trainer(dev, True)
    for _ in range(2):
        trainer.train_step(x, y)
    torch.cuda.synchronize()
    timer = StepTimer()
    for _ in range(10):
        timer.start()
        timer.stop(trainer.train_step(x, y))
    print("steps (fused attack), ms: " + " ".join(
        f"{v * 1e3:.1f}" for v in timer.times), flush=True)


def one(tree: str, what: str) -> None:
    """The runs of one checkout, in this process."""
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from robseg_torch.infer import set_numerics
    from robseg_torch.kernels import _build
    dev = torch.device("cuda")
    set_numerics()
    print(f"{tree} [{smi('name,power.limit')}]", flush=True)
    t0 = time.time()
    _build.build()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    if what in ("kernels", "all"):
        with cs.strict_float32():
            results = {}
            cs.phase_kernels(dev, results)
            cs.phase_fpn(dev, results)
            cs.phase_mlp(dev, results)
            cs.phase_bf16_kernels(dev, results)
    if what in ("paths", "all"):
        bundle = cs.build_model(dev)
        cs.phase_apgd(dev, bundle.logits_fn)
        cs.phase_profile(dev, bundle.logits_fn)
        bf16_fn = cs.fused_model(dev, bundle.module.state_dict(), "bf16")
        cs.phase_apgd(dev, bf16_fn, label="bf16 main path")
        cs.phase_profile(dev, bf16_fn, label="bf16 main-path")
        del bundle, bf16_fn
        torch.cuda.empty_cache()
        cs.phase_train_step(dev, smi("name,power.limit"))
    if what == "fpn":
        fpn_turns(cs, dev)
    if what == "steps":
        train_steps(cs, dev)
    if what == "confusion":
        confusion_turns(cs, dev)
    if what == "launch":
        launch_turns(cs, dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="all",
                    choices=("kernels", "paths", "all", "fpn", "steps",
                             "confusion", "launch"))
    ap.add_argument("--out", default=os.path.join(REPO, "outputs",
                                                   "chip_ab"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.one:
        one(os.path.abspath(args.dirs[0]), args.what)
        return
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    logs = []
    for i, tree in enumerate(args.dirs, 1):
        tree = os.path.abspath(tree)
        name = os.path.basename(tree.rstrip("/")) or "root"
        log = os.path.join(out, f"ab_{i}_{name}_{args.what}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--one", "--what", args.what, tree],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        print(f"run {i} {tree}: rc {rc}, {log}", flush=True)
        if rc:
            sys.exit(rc)
        logs.append(log)
    for log in logs:
        print(f"== {log}")
        with open(log) as f:
            for line in f:
                if SUMMARY.search(line):
                    print(line.rstrip()[:900])


if __name__ == "__main__":
    main()
