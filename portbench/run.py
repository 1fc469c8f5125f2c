#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name: ``BENCHMARK.json`` beside this folder names its
configuration and metrics, ``workloads/<cell>.json`` its traffic, entry,
sampling and limits, ``configs/<config>.json`` its model, ``entries/
<entry>.py`` the code that drives the program (``robseg_torch``) through
the window, and ``metrics/<metric>.py`` each per-layer metric's reader.
With ``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a traced slice of the window.
The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.

Exit codes: 0 a result; 3 no CUDA card or fewer than the cell needs; 4 a
module of JAX or of the JAX package was loaded; anything else a failure.
``--device cpu`` (the harness's own tests) runs on the CPU through the
program's plain paths; ``--control`` runs the program's own path of the
precision below the configuration's (the cell's ``control``) in the
program's place, and ``--fault`` plants a fault under the timed path (a
step that leaves its state unchanged, half of the batch left out, one value
of the answer altered), to read the upper ends of the limits.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "robseg_tpu")
CACHE = ".portbench_cache"


def cache_env(root: Path) -> None:
    """Every build and kernel cache a run may write, at fixed paths inside
    the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(root / CACHE / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file (an entry, a metric reader) by its path."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What an entry gets: the cell's files, the device and the run's
    arguments."""
    name: str
    cfg: dict
    workload: dict
    device: object
    seed: int
    seconds: float
    trace: bool
    control: bool
    fault: str
    t0: float


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="",
                   choices=("", "unchanged", "half_batch", "altered"))
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return p.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def setup(args, bench_dir: Path = HERE):
    """(benchmark, cell entry, workload, configuration) of ``args``."""
    root = bench_dir.parent
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    wl = load_json(bench_dir / "workloads" / f"{args.workload}.json")
    cfg = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    return bench, cell, wl, cfg


def device_or_exit(args, cell):
    import torch
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{count} visible", file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def run_entry(args, bench_dir: Path, wl, cfg, dev, seed: int, t0: float):
    entry = load_module(bench_dir / "entries" / f"{wl['entry']}.py")
    ctx = Context(args.workload, cfg, wl, dev, seed, args.seconds,
                  bool(args.trace), args.control, args.fault, t0)
    return entry.run(ctx)


def result(args, bench, cell, bench_dir, outcome, dev) -> dict:
    import torch
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if not applies(m, args.workload) or outcome.observation is None:
                continue
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py")
            v = reader.read(outcome.observation)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = {"value": outcome.values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu", "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": all(lim is not None and not math.isnan(v) and v <= lim
                          for _, v, lim in outcome.checks),
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    obs = outcome.observation
    if args.trace and obs is not None:
        from portbench.trace import breakdown
        device["busy_s"] = obs.busy_s
        device["window_s"] = obs.window_s
        bd = breakdown(obs.ops, obs.window_s)
        if bd:
            out["breakdown"] = bd
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in outcome.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    cache_env(ROOT)
    bench, cell, wl, cfg = setup(args)
    dev = device_or_exit(args, cell)
    outcome = run_entry(args, HERE, wl, cfg, dev, args.seed, T0)
    out = result(args, bench, cell, HERE, outcome, dev)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in outcome.notes:
        print(line, file=sys.stderr)
    if dev.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, v, lim in outcome.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
