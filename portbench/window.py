"""The measured window and what a run hands back to ``run.py``.

A ``Window`` opens after set-up and closes at the first unit boundary (a
model call, a training step) after ``--seconds`` have passed: ``tick()``
there marks the boundary on the device's timeline (a CUDA event; the host
clock on the CPU, where only the tests run) and raises ``WindowClosed`` once
the deadline has passed, after synchronising. A rate is the work of every
unit finished in the window over the window's whole length on the host's
clock; a tail is taken over every interval between consecutive boundaries.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Tuple

import torch


class WindowClosed(Exception):
    """Raised at the first unit boundary after the deadline."""


class Window:
    def __init__(self, device: torch.device, seconds: float):
        self.cuda = device.type == "cuda"
        self.seconds = seconds
        self.marks: list = []
        self.t0 = self.t1 = self.deadline = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def open(self) -> None:
        self._sync()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    @property
    def is_open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def tick(self) -> None:
        """A unit boundary: the window closes here once the deadline has
        passed, else the boundary is marked."""
        self.marks.append(self._mark())
        if time.perf_counter() >= self.deadline:
            self._sync()
            self.t1 = time.perf_counter()
            raise WindowClosed

    @property
    def length_s(self) -> float:
        return self.t1 - self.t0

    @property
    def units(self) -> int:
        """Units finished: every boundary but the closing one starts a
        unit that the closing sync saw end."""
        return max(len(self.marks) - 1, 0)

    def intervals_ms(self) -> List[float]:
        """Every interval between consecutive boundaries, device clock."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def percentile(values, p: int) -> float:
    """The p-th percentile (1..99) over all values, inclusive method."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: the work attempted and failed, the
    end-to-end values, each compared number as (name, value, limit), the
    device's peak, the traced slice's observation (``--trace 1``), and
    lines for standard error that come before the comparison."""
    attempted: int
    failed: int
    values: Dict[str, float]
    checks: List[Tuple[str, float, Optional[float]]]
    memory_peak_bytes: int
    observation: object = None
    notes: List[str] = dataclasses.field(default_factory=list)
