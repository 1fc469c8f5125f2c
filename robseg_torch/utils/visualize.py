"""Segmentation palettes and mask rendering (numpy and PIL).

A copy of ``robseg_tpu/utils/visualize.py``, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package. Parity
target: ``semseg/utils/visualize.py`` — the literal ADE20K 150-class
color table (``visualize.py:43-193``), the PASCAL-VOC table
(``visualize.py:196-218``), ``generate_palette`` (``visualize.py:221-230``)
and ``draw_text`` (``visualize.py:233-256``). The VOC table equals the
canonical bit-reversal construction (verified equal element-for-element);
the ADE table is upstream's hand-picked scene-parsing palette and is kept
as a literal so ADE renders are byte-identical to the reference's.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

# ADE20K 150-class palette — literal parity with ``visualize.py:43-193``
# (a constant table defines the rendering semantics; values must match).
ADE_PALETTE = np.array([
    (120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50), (4, 200, 3),
    (120, 120, 80), (140, 140, 140), (204, 5, 255), (230, 230, 230), (4, 250, 7),
    (224, 5, 255), (235, 255, 7), (150, 5, 61), (120, 120, 70), (8, 255, 51),
    (255, 6, 82), (143, 255, 140), (204, 255, 4), (255, 51, 7), (204, 70, 3),
    (0, 102, 200), (61, 230, 250), (255, 6, 51), (11, 102, 255), (255, 7, 71),
    (255, 9, 224), (9, 7, 230), (220, 220, 220), (255, 9, 92), (112, 9, 255),
    (8, 255, 214), (7, 255, 224), (255, 184, 6), (10, 255, 71), (255, 41, 10),
    (7, 255, 255), (224, 255, 8), (102, 8, 255), (255, 61, 6), (255, 194, 7),
    (255, 122, 8), (0, 255, 20), (255, 8, 41), (255, 5, 153), (6, 51, 255),
    (235, 12, 255), (160, 150, 20), (0, 163, 255), (140, 140, 140), (250, 10, 15),
    (20, 255, 0), (31, 255, 0), (255, 31, 0), (255, 224, 0), (153, 255, 0),
    (0, 0, 255), (255, 71, 0), (0, 235, 255), (0, 173, 255), (31, 0, 255),
    (11, 200, 200), (255, 82, 0), (0, 255, 245), (0, 61, 255), (0, 255, 112),
    (0, 255, 133), (255, 0, 0), (255, 163, 0), (255, 102, 0), (194, 255, 0),
    (0, 143, 255), (51, 255, 0), (0, 82, 255), (0, 255, 41), (0, 255, 173),
    (10, 0, 255), (173, 255, 0), (0, 255, 153), (255, 92, 0), (255, 0, 255),
    (255, 0, 245), (255, 0, 102), (255, 173, 0), (255, 0, 20), (255, 184, 184),
    (0, 31, 255), (0, 255, 61), (0, 71, 255), (255, 0, 204), (0, 255, 194),
    (0, 255, 82), (0, 10, 255), (0, 112, 255), (51, 0, 255), (0, 194, 255),
    (0, 122, 255), (0, 255, 163), (255, 153, 0), (0, 255, 10), (255, 112, 0),
    (143, 255, 0), (82, 0, 255), (163, 255, 0), (255, 235, 0), (8, 184, 170),
    (133, 0, 255), (0, 255, 92), (184, 0, 255), (255, 0, 31), (0, 184, 255),
    (0, 214, 255), (255, 0, 112), (92, 255, 0), (0, 224, 255), (112, 224, 255),
    (70, 184, 160), (163, 0, 255), (153, 0, 255), (71, 255, 0), (255, 0, 163),
    (255, 204, 0), (255, 0, 143), (0, 255, 235), (133, 255, 0), (255, 0, 235),
    (245, 0, 255), (255, 0, 122), (255, 245, 0), (10, 190, 212), (214, 255, 0),
    (0, 204, 255), (20, 0, 255), (255, 255, 0), (0, 153, 255), (0, 41, 255),
    (0, 255, 204), (41, 0, 255), (41, 255, 0), (173, 0, 255), (0, 245, 255),
    (71, 0, 255), (122, 0, 255), (0, 255, 184), (0, 92, 255), (184, 255, 0),
    (0, 133, 255), (255, 214, 0), (25, 194, 194), (102, 255, 0), (92, 0, 255),
], np.uint8)


def voc_palette(num_classes: int = 21) -> np.ndarray:
    """The canonical PASCAL-VOC palette (bit-reversal construction).

    Equals the reference's literal ``colors_voc`` table
    (``visualize.py:196-218``) for the first 21 entries — asserted in
    tests/test_utils.py.
    """
    def bitget(v, i):
        return (v >> i) & 1

    pal = np.zeros((num_classes, 3), np.uint8)
    for k in range(num_classes):
        r = g = b = 0
        c = k
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        pal[k] = (r, g, b)
    return pal


def generate_palette(num_classes: int, background: bool = False
                     ) -> np.ndarray:
    """Reference-compatible palette lookup (``visualize.py:221-230``):
    150 -> the ADE table, 21 -> the VOC table; ``background=True``
    prepends black and keeps the first ``num_classes - 1`` colors.
    Other class counts (which KeyError upstream) fall back to a
    deterministic HSV spread.
    """
    if num_classes == 150:
        colors = ADE_PALETTE
    elif num_classes == 21:
        colors = voc_palette(21)
    else:
        colors = hsv_palette(num_classes)
    if background:
        return np.concatenate(
            [np.zeros((1, 3), np.uint8), colors[: num_classes - 1]])
    return colors[:num_classes].copy()


def hsv_palette(num_classes: int, seed: int = 0) -> np.ndarray:
    """Deterministic HSV-spread palette for arbitrary class counts
    (fallback; no reference analogue — upstream only ships 150/21)."""
    rng = np.random.default_rng(seed)
    pal = np.zeros((num_classes, 3), np.uint8)
    for k in range(num_classes):
        h = (k * 0.6180339887) % 1.0  # golden-ratio hue spread
        s = 0.55 + 0.4 * float(rng.random())
        v = 0.7 + 0.3 * float(rng.random())
        pal[k] = tuple(int(255 * c) for c in colorsys.hsv_to_rgb(h, s, v))
    return pal


def colorize_mask(mask: np.ndarray, palette: Optional[np.ndarray] = None,
                  num_classes: Optional[int] = None,
                  ignore_label: int = -1) -> np.ndarray:
    """(H, W) int mask -> (H, W, 3) uint8 RGB; ignored pixels are black."""
    if palette is None:
        n = num_classes or int(mask.max()) + 1
        palette = generate_palette(n) if n in (21, 150) else hsv_palette(n)
    out = np.zeros(mask.shape + (3,), np.uint8)
    valid = mask != ignore_label
    out[valid] = palette[np.clip(mask[valid], 0, len(palette) - 1)]
    return out


def overlay(image: np.ndarray, mask_rgb: np.ndarray,
            alpha: float = 0.5) -> np.ndarray:
    """Blend a [0,1] float image with a palette mask."""
    img = (image * 255).astype(np.float32)
    return np.clip((1 - alpha) * img + alpha * mask_rgb.astype(np.float32),
                   0, 255).astype(np.uint8)


def draw_text(image: np.ndarray, seg_map: np.ndarray,
              labels: Sequence[str], fontsize: int = 15):
    """Annotate each segment with its class name at the mask median.

    Parity: ``visualize.py:233-256`` (numpy/PIL instead of torch tensors;
    the reference hardcodes ``assests/Helvetica.ttf`` — absent there too
    unless the user supplies it — so we fall back to PIL's default font
    when no truetype Helvetica is available).
    """
    from PIL import Image, ImageDraw, ImageFont

    img = np.asarray(image).astype(np.uint8)
    pil_image = Image.fromarray(img)
    draw = ImageDraw.Draw(pil_image)
    try:
        font = ImageFont.truetype("assests/Helvetica.ttf", fontsize)
    except OSError:
        font = ImageFont.load_default()

    seg = np.asarray(seg_map)
    indices = np.unique(seg).tolist()
    classes = [labels[int(index)] for index in indices]
    for idx, cls in zip(indices, classes):
        mask = np.squeeze(seg == idx)
        center = tuple(np.median(np.nonzero(mask == 1), axis=1)[::-1])
        bbox = draw.textbbox(center, cls, font=font)
        bbox = (bbox[0] - 3, bbox[1] - 3, bbox[2] + 3, bbox[3] + 3)
        draw.rectangle(bbox, fill=(255, 255, 255), width=1)
        draw.text(center, cls, fill=(0, 0, 0), font=font)
    return pil_image
