"""Synchronized image/mask transforms; a copy of
``robseg_tpu/data/transforms.py`` (numpy and PIL only, copied because
``robseg_tpu`` cannot be imported without JAX). Reference
``semseg/datasets/dataset_wrappers.py:23-93``: val resizes the short edge
to the crop and center-crops; train flips (p 0.5), scales the short edge
to U[0.5, 2] x base_size, pads bottom/right to the crop, blurs (p 0.5,
radius U(0, 1)) and crops at random, drawing from the ``random.Random``
it is given."""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageFilter, ImageOps


def val_sync_transform(img: Image.Image, mask: Image.Image,
                       crop_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resize the short edge to crop_size (bilinear image, nearest mask),
    then center-crop; parity ``dataset_wrappers.py:23-43``."""
    outsize = crop_size
    short_size = outsize
    w, h = img.size
    if w > h:
        oh = short_size
        ow = int(1.0 * w * oh / h)
    else:
        ow = short_size
        oh = int(1.0 * h * ow / w)
    img = img.resize((ow, oh), Image.BILINEAR)
    mask = mask.resize((ow, oh), Image.NEAREST)
    w, h = img.size
    x1 = int(round((w - outsize) / 2.0))
    y1 = int(round((h - outsize) / 2.0))
    img = img.crop((x1, y1, x1 + outsize, y1 + outsize))
    mask = mask.crop((x1, y1, x1 + outsize, y1 + outsize))
    return np.array(img), np.array(mask).astype("int32")


def train_sync_transform(img: Image.Image, mask: Image.Image, *,
                         base_size: int, crop_size: int,
                         rng: Optional[random.Random] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Parity: ``dataset_wrappers.py:45-93``."""
    r = rng if rng is not None else random
    if r.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    short_size = r.randint(int(base_size * 0.5), int(base_size * 2.0))
    w, h = img.size
    if h > w:
        ow = short_size
        oh = int(1.0 * h * ow / w)
    else:
        oh = short_size
        ow = int(1.0 * w * oh / h)
    img = img.resize((ow, oh), Image.BILINEAR)
    mask = mask.resize((ow, oh), Image.NEAREST)
    if short_size < crop_size:
        padh = crop_size - oh if oh < crop_size else 0
        padw = crop_size - ow if ow < crop_size else 0
        img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
        mask = ImageOps.expand(mask, border=(0, 0, padw, padh), fill=0)
    if r.random() < 0.5:
        img = img.filter(ImageFilter.GaussianBlur(radius=r.random()))
    w, h = img.size
    x1 = r.randint(0, w - crop_size)
    y1 = r.randint(0, h - crop_size)
    img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    mask = mask.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    return np.array(img), np.array(mask).astype("int32")


def to_float_chw_last(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1]."""
    return img.astype(np.float32) / 255.0
