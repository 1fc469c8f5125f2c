"""Sliding-window and multi-scale + flip inference on NCHW tensors.

Port of ``robseg_tpu/utils/sliding_window.py``:

  * ``sliding_window_logits`` (reference ``semseg/utils/segmenter_eval.py:
    51-123``): pad the image bottom/right to at least the window, run the
    model over a regular grid of (window, stride) crops in one batched
    call, average overlapping logits, crop back;
  * ``multi_scale_flip_logits`` (reference ``semseg/val.py:329-374``,
    ``evaluate_msf``): each scale is rounded up to a multiple of ``align``,
    images are resized with ``resize_bilinear(align_corners=True)``, and
    softmax probabilities (not logits) are summed over scales and flips.

Both run the model they are given, so on CUDA tensors they run its
kernels.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from robseg_torch.ops.resize import resize_bilinear


def sliding_window_logits(logits_fn: Callable, image: torch.Tensor, *,
                          window: int = 512, stride: int = 512,
                          num_classes: int) -> torch.Tensor:
    """image ``(3, H, W)`` -> logits ``(C, H, W)`` averaged over the window
    grid; ``logits_fn`` maps ``(n, 3, window, window)`` to
    ``(n, C, window, window)``."""
    h, w = image.shape[1:]
    pad_h, pad_w = max(window - h, 0), max(window - w, 0)
    if pad_h or pad_w:
        image = F.pad(image, (0, pad_w, 0, pad_h))
    ph, pw = image.shape[1:]

    hs = list(range(0, max(ph - window, 0) + 1, stride))
    ws = list(range(0, max(pw - window, 0) + 1, stride))
    if hs[-1] + window < ph:
        hs.append(ph - window)
    if ws[-1] + window < pw:
        ws.append(pw - window)

    crops = torch.stack([image[:, i:i + window, j:j + window]
                         for i in hs for j in ws])
    logits = logits_fn(crops)  # (n, C, window, window) in one call

    out = torch.zeros((num_classes, ph, pw), dtype=logits.dtype,
                      device=logits.device)
    count = torch.zeros((1, ph, pw), dtype=logits.dtype,
                        device=logits.device)
    idx = 0
    for i in hs:
        for j in ws:
            out[:, i:i + window, j:j + window] += logits[idx]
            count[:, i:i + window, j:j + window] += 1.0
            idx += 1
    return (out / count)[:, :h, :w]


def multi_scale_flip_logits(logits_fn: Callable, images: torch.Tensor, *,
                            scales=(1.0,), flip: bool = False,
                            num_classes: int, align: int = 32
                            ) -> torch.Tensor:
    """images ``(B, 3, H, W)`` -> the sum of softmax probabilities
    ``(B, C, H, W)`` (float32) over ``scales`` and, with ``flip``, their
    horizontal flips."""
    b, _, h, w = images.shape
    acc = torch.zeros((b, num_classes, h, w), dtype=torch.float32,
                      device=images.device)
    for scale in scales:
        nh = -(-int(scale * h) // align) * align
        nw = -(-int(scale * w) // align) * align
        scaled = resize_bilinear(images, (nh, nw), align_corners=True)
        logits = resize_bilinear(logits_fn(scaled), (h, w),
                                 align_corners=True)
        acc = acc + torch.softmax(logits, 1)
        if flip:
            logits = logits_fn(torch.flip(scaled, (3,))).flip(3)
            logits = resize_bilinear(logits, (h, w), align_corners=True)
            acc = acc + torch.softmax(logits, 1)
    return acc
