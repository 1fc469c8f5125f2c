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
  two, each step's time.

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
    r"|apgd .*marginal|^train step \(|^fpn gemm|^steps")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="all",
                    choices=("kernels", "paths", "all", "fpn", "steps"))
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
