"""attack_iter_ms.p50: the median of every interval between consecutive
model calls of the window, from the harness's CUDA events (ms). Beside the
p95: where the p95 moves and the median does not, the cost sits at the
boundaries (phases, batches, scoring)."""

from portbench.window import percentile


def read(obs):
    return percentile(obs.intervals_ms, 50) if obs.intervals_ms else None
