"""Measures shared by the entries' comparisons with the reference."""

from __future__ import annotations


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def over(num: float, den: float) -> float:
    """num / den, with 0 / 0 = 0 and x / 0 = inf."""
    if den > 0:
        return num / den
    return 0.0 if num == 0 else float("inf")


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    ``|prog[n] - ref[n]|``, over the larger of the reference's norm of that
    leaf and of the median leaf among ``names``; a leaf the program does
    not report reads 0."""
    med = _median([ref[n] for n in names])
    return max((over(abs(prog.get(n, 0.0) - ref[n]), max(ref[n], med))
                for n in names), default=0.0)


def moved_leaves(first_grad: dict, names) -> list:
    """The leaves among ``names`` that a step moves by more than
    round-off: all but those whose first gradient's norm (in the
    reference) is under a thousandth of the median leaf's. A leaf with no
    gradient (a BatchNorm statistic) is kept."""
    med = _median(list(first_grad.values()))
    return [n for n in names
            if n not in first_grad or first_grad[n] >= 1e-3 * med]
