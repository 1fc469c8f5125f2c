"""FLOPs of a function, counted by ``torch.utils.flop_counter``.

Port of ``robseg_tpu/utils/flops.py``, which reads XLA's cost analysis of
the compiled function. Here ``fn`` runs once, eagerly, under
``FlopCounterMode``, which counts the floating-point operations of the
products (convolutions, matmuls, attention: 2 per multiply-add) from
their shapes, and nothing else. torch counts no bytes, so the result has
no ``bytes accessed`` key.
"""

from __future__ import annotations

from typing import Callable, Dict

from torch.utils.flop_counter import FlopCounterMode


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """``{"flops": ...}`` of one call ``fn(*example_args)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def pretty_flops(fn: Callable, *example_args) -> str:
    flops = cost_analysis(fn, *example_args)["flops"]
    return f"{flops / 1e9:.2f} GFLOPs (bytes accessed: not counted)"
