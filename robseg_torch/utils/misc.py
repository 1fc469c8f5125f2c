"""Seeds and parameter counting.

Port of ``robseg_tpu/utils/misc.py`` (``fix_seeds``: reference
``semseg/utils/utils.py:323-334``). Where JAX returns a PRNG key, the
port seeds torch's global generators (CPU and every CUDA device) as the
reference does and returns a ``torch.Generator`` seeded alike for code
that takes one explicitly.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn as nn


def fix_seeds(seed: int = 123) -> torch.Generator:
    """Seed ``random``, numpy and torch; a CPU generator seeded with
    ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def model_param_count(module: nn.Module) -> int:
    """The number of parameter entries (JAX: the ``params`` leaves;
    BatchNorm statistics are buffers here and a collection of their own
    there, counted by neither)."""
    return sum(p.numel() for p in module.parameters())


def model_size_mb(module: nn.Module) -> float:
    """The parameters' bytes in MiB."""
    return sum(p.numel() * p.element_size()
               for p in module.parameters()) / 1024 ** 2
