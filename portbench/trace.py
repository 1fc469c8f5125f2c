"""The traced slice of a ``--trace 1`` run and its reduction.

``Slice`` profiles a bounded part of the measured window with
``torch.profiler`` (CPU and CUDA activity), inside a span named
``portbench.slice``, and exports the Chrome trace into the run's temporary
directory, which is read back and deleted. ``Observation`` holds what the
per-layer metrics read: the device's operations (kernels, copies, memsets)
with their names, device intervals and the host op that launched each, the
slice's length, and the work done in it.

The kinds of kernel are chip_smoke.py's classifier (``kernel_kind``),
copied: a later change to that script does not move these metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

SLICE_SPAN = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float   # us, the trace's clock
    dur: float     # us
    launcher: str  # innermost host op or span around its launch


@dataclasses.dataclass
class Observation:
    """What one traced slice saw; the per-layer metrics read it."""
    ops: List[DeviceOp]
    window_s: float
    busy_s: float
    units: int                 # iterations or steps in the slice
    flops_per_unit: float      # the reference's FLOPs of one unit
    cfg: dict
    workload: dict
    intervals_ms: List[float]  # every model-call interval of the window
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def device_ms(self, pred) -> float:
        return sum(op.dur for op in self.ops if pred(op)) / 1e3


def block_part(name: str) -> str:
    """Which part of the block kernels a profiled kernel is (chip_smoke.py
    ``block_part``)."""
    if "mlp_fused_kernel" in name or "mlp_gemm_kernel" in name:
        return "mlp"
    if "dwconv_ln_kernel" in name or "dwcorr_kernel" in name:
        return "depthwise"
    if "ln_bwd_kernel" in name:
        return "ln_bwd"
    return "packing"


def kernel_kind(name: str) -> str:
    """The kind of a profiled kernel (chip_smoke.py ``kernel_kind`` on a
    path without the MLP-tail mode)."""
    part = block_part(name)
    if "mlp_tf32_kernel" in name or "ln_rows_kernel" in name:
        return "MLP tail"
    if any(k in name for k in ("fpn_gemm_kernel", "to_bf16_kernel",
                               "relu_grad_kernel")):
        return "FPN concat-conv"
    if part != "packing":
        return f"block {part}"
    low = name.lower()
    if "norm" in low or "bn_" in low:
        return "elementwise, norms, resize, loss"
    if any(k in low for k in ("cudnn", "conv", "dgrad", "wgrad", "fprop",
                              "implicit")):
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low or "nvjet" in low:
        return "matmul (cuBLAS)"
    if "apgd" in low or "confusion" in low:
        return "APGD step, confusion"
    return "elementwise, norms, resize, loss"


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Slice:
    """Profile from ``start()`` to ``stop()``; each synchronises first, so
    the slice holds exactly the work launched between them."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.span = None
        self.t0 = self.seconds = None
        self.path = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function(SLICE_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    @property
    def done(self) -> bool:
        return self.path is not None

    def events(self) -> list:
        try:
            with open(self.path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)


def reduce_trace(events: list) -> Tuple[List[DeviceOp], float, float]:
    """(device ops inside the slice, slice length in s, device busy s):
    each device op named, with the innermost host op around its launch."""
    slice_ev = [e for e in events if e.get("name") == SLICE_SPAN
                and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not slice_ev:
        return [], 0.0, 0.0
    s0 = float(slice_ev[0]["ts"])
    s1 = s0 + float(slice_ev[0]["dur"])
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur <= s0 or ts >= s1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        device.append((launch.get(corr, (ts, None)), e["name"],
                       max(ts, s0), min(ts + dur, s1)))
    # a sweep over each host thread's nested ops in start order: at a
    # launch, the open ops of its thread are those around it
    host: Dict[object, list] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and e["name"] != SLICE_SPAN):
            t = float(e["ts"])
            h = (t, t + float(e.get("dur", 0)), e["name"])
            host.setdefault(e.get("tid"), []).append(h)
    for evs in host.values():
        evs.sort(key=lambda h: (h[0], -h[1]))
    pos = {tid: 0 for tid in host}
    stacks: Dict[object, list] = {tid: [] for tid in host}
    ops = []
    for (lts, tid), name, a, b in sorted(device, key=lambda d: d[0][0]):
        evs, stack = host.get(tid, []), stacks.get(tid, [])
        i = pos.get(tid, 0)
        while i < len(evs) and evs[i][0] <= lts:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        pos[tid] = i
        while stack and stack[-1][1] < lts:
            stack.pop()
        ops.append(DeviceOp(name, a, b - a, stack[-1][2] if stack else ""))
    busy = union_us((op.start, op.start + op.dur) for op in ops) / 1e6
    return ops, (s1 - s0) / 1e6, busy


def breakdown(ops: List[DeviceOp], window_s: float) -> Optional[dict]:
    """The ten device operations that took most time and the ten longest
    idle gaps, each gap named by the host op that launched the operation
    that ended it; seconds."""
    if not ops:
        return None
    by_name: Dict[str, float] = {}
    for op in ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.dur / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for op in sorted(ops, key=lambda o: o.start):
        if end is not None and op.start > end:
            host = op.launcher or "?"
            gaps.append(((op.start - end) / 1e6,
                         f"before {op.name[:60]} (host: {host})"))
        end = max(end or op.start, op.start + op.dur)
    gaps.sort(key=lambda g: -g[0])
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for s, n in gaps[:10]]}
