"""Bilinear resize and adaptive average pooling on NCHW tensors.

Port of ``robseg_tpu/ops/resize.py``: both are separable linear maps along
H and W, applied as two matmuls with float32 interpolation matrices built
as the JAX package builds them (cached per size, device and dtype). So the
port reproduces the JAX resizes to float32 rounding, where
``F.interpolate``'s float32 source coordinates drift by up to ~1e-5
relative at 119 -> 473.

  * bilinear, align_corners=False (UperNet, Segmenter): source =
    (i + 0.5) * in / out - 0.5, clamped to [0, in - 1];
  * bilinear, align_corners=True (PSPNet, DeepLab): source =
    i * (in - 1) / (out - 1), and 0 where out = 1;
  * adaptive average pooling: the mean over
    [floor(i * in / out), ceil((i + 1) * in / out)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from robseg_torch.ops import precision


def _interp_matrix_np(in_size: int, out_size: int,
                      align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear-interpolation matrix."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (
                out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
            in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - w_hi
    m[rows, hi] += w_hi
    return m


def _pool_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix for adaptive avg pooling."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)  # ceil
        m[i, s:e] = 1.0 / (e - s)
    return m


@functools.lru_cache(maxsize=128)
def _matrix(kind: str, in_size: int, out_size: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    if kind == "pool":
        m = _pool_matrix_np(in_size, out_size)
    else:
        m = _interp_matrix_np(in_size, out_size, kind == "corners")
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def _separable(x: torch.Tensor, kind: str, out_hw) -> torch.Tensor:
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    mh = _matrix(kind, h, oh, x.device, x.dtype)
    mw = _matrix(kind, w, ow, x.device, x.dtype)
    return precision.matmul(precision.matmul(mh, x), mw.t())


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``."""
    return _separable(x, "corners" if align_corners else "bilinear", out_hw)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch AdaptiveAvgPool2d semantics for NCHW tensors."""
    return _separable(x, "pool", out_hw)
