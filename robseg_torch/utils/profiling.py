"""Profiling and timing hooks (the reference has none).

Port of ``robseg_tpu/utils/profiling.py``: a ``torch.profiler`` trace
around any span, and a per-step timer that waits for the card on read.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the span (CPU activity, and CUDA where there is a card)
    and write a Chrome trace into ``log_dir`` (TensorBoard's layout,
    ``<worker>.<time>.pt.trace.json``; Perfetto reads it too); no trace
    when ``log_dir`` is ``None``."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


class StepTimer:
    """Wall-clock per-step timing; ``stop`` waits for the CUDA devices of
    the tensors it is given first."""

    def __init__(self):
        self.t0 = None
        self.times = []

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self, *sync_tensors: torch.Tensor):
        for d in {t.device for t in sync_tensors if t.is_cuda}:
            torch.cuda.synchronize(d)
        self.times.append(time.perf_counter() - self.t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> str:
        if not self.times:
            return "no steps timed"
        ts = sorted(self.times)
        return (f"steps={len(ts)} mean={self.mean * 1e3:.1f}ms "
                f"p50={ts[len(ts) // 2] * 1e3:.1f}ms "
                f"max={ts[-1] * 1e3:.1f}ms")
