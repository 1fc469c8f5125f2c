"""The window arithmetic: a rate over all the work and all the time of the
window, a tail over every interval, no medians of chunks."""

from __future__ import annotations

import statistics

import pytest
import torch

from portbench import window as wmod


def test_rate_and_tail_over_the_whole_window(monkeypatch):
    # a boundary every 10 ms, one stall of 200 ms, the deadline at 1 s
    now = {"t": 0.0}
    monkeypatch.setattr(wmod.time, "perf_counter", lambda: now["t"])
    w = wmod.Window(torch.device("cpu"), 1.0)
    w.open()
    ticks = [0.01 * i for i in range(1, 40)] + \
        [0.59 + 0.01 * i for i in range(60)]
    with pytest.raises(wmod.WindowClosed):
        for t in ticks:
            now["t"] = t
            w.tick()
    # the window closed at the first boundary at or after 1 s
    assert w.t1 == pytest.approx(1.0)
    iv = w.intervals_ms()
    assert len(iv) == w.units == 39 + 41
    # the rate: every unit finished over the window's whole length
    assert w.units * 16 / w.length_s == pytest.approx(80 * 16 / 1.0)
    assert max(iv) == pytest.approx(200.0)
    assert wmod.percentile(iv, 95) == pytest.approx(
        statistics.quantiles(iv, n=100, method="inclusive")[94])


def test_percentile_is_over_all_values():
    values = [1.0] * 90 + [10.0] * 10
    assert wmod.percentile(values, 95) == 10.0
    assert wmod.percentile(values, 50) == 1.0
    # a median of chunk medians would hide the tail
    chunks = [statistics.median(values[i:i + 10]) for i in range(0, 100, 10)]
    assert statistics.median(chunks) == 1.0
