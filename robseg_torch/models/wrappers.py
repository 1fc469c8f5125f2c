"""Model wrappers: input normalization and logit-channel masking.

Port of ``robseg_tpu/models/wrappers.py`` (``ImageNormalizer`` /
``normalize_model`` and ``MaskClass`` / ``mask_logits`` of the reference)
as function combinators over a ``logits_fn``. The JAX versions work on the
last (channel) axis of NHWC tensors; these work on axis 1 of NCHW ones.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

IN_MEAN = (0.485, 0.456, 0.406)
IN_STD = (0.229, 0.224, 0.225)


def normalize_input(x: torch.Tensor, mean: Sequence[float] = IN_MEAN,
                    std: Sequence[float] = IN_STD) -> torch.Tensor:
    """(x - mean) / std over the channel axis (1)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    m = torch.tensor(mean, dtype=x.dtype, device=x.device).view(shape)
    s = torch.tensor(std, dtype=x.dtype, device=x.device).view(shape)
    return (x - m) / s


def normalize_model(logits_fn: Callable, mean: Sequence[float] = IN_MEAN,
                    std: Sequence[float] = IN_STD) -> Callable:
    """Prepend input normalization to a logits_fn."""
    return lambda x: logits_fn(normalize_input(x, mean, std))


def mask_class(logits: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Drop one class channel (axis 1) from NCHW logits."""
    if ignore_index == 0:
        return logits[:, 1:]
    return torch.cat([logits[:, :ignore_index], logits[:, ignore_index + 1:]],
                     dim=1)


def mask_logits(logits_fn: Callable, ignore_index: int) -> Callable:
    """Wrap a logits_fn so one class channel is removed from its output."""
    return lambda x: mask_class(logits_fn(x), ignore_index)
