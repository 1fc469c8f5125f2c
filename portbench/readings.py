#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process: the
program's (the lower ends of the limits), the control's and the planted
faults' (the upper ends). Not part of a benchmark run.

    python3 portbench/readings.py --workload <cell> --seconds <s> \
        --seeds <first> <count> [--variants program control half_batch ...]

Each variant runs the cell's entry once per seed, as ``run.py`` would with
``--control`` or ``--fault``, and prints one JSON line per run: the seed,
the variant, the compared numbers and the end-to-end values; the last
line sums each number up per variant (least, largest).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import run as harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True)
    p.add_argument("--variants", nargs="+", default=["program"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    harness.cache_env(HERE.parent)
    import torch
    summary = {}
    for variant in args.variants:
        for seed in range(args.seeds[0], args.seeds[0] + args.seeds[1]):
            run_args = harness.parse([
                "--workload", args.workload, "--seed", str(seed),
                "--seconds", str(args.seconds), "--device", args.device]
                + (["--control"] if variant == "control" else [])
                + ([] if variant in ("program", "control")
                   else ["--fault", variant]))
            _, cell, wl, cfg = harness.setup(run_args)
            dev = harness.device_or_exit(run_args, cell)
            out = harness.run_entry(run_args, HERE, wl, cfg, dev, seed,
                                    time.perf_counter())
            checks = {n: v for n, v, _ in out.checks}
            print(json.dumps({"variant": variant, "seed": seed,
                              "checks": checks, "values": out.values,
                              "notes": out.notes}), flush=True)
            for n, v in checks.items():
                lo, hi = summary.setdefault(variant, {}).get(n, (v, v))
                summary[variant][n] = (min(lo, v), max(hi, v))
            del out
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
