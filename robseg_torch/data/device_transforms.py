"""On-device training augmentation (``TRAIN.DEVICE_AUG``).

Torch form of ``robseg_tpu/data/device_transforms.py``. The host only loads
and zero-pads (``load_raw_batch``, numpy and PIL, copied); flip, random
short-edge scale in [0.5, 2] x ``base_size``, zero padding to the crop,
Gaussian blur (p = 0.5) and random crop run on the card as one affine map
from output-crop coordinates to source coordinates, read with a bilinear
gather for images and a nearest one for masks. Samples outside the buffer
read 0 (image) and label 0 (mask), the reference's bottom-right zero
padding. The blur is a separable 5-tap Gaussian with sigma = radius.

Numerics note, as in the JAX package: PIL's bilinear resize antialiases
when it downscales and a direct bilinear read does not, so these crops are
not the host pipeline's pixels; both are instances of the same
augmentation.

The per-image sampler is split in two: ``draw_augment_params`` draws the
six scalars of each image (short edge, crop origin in y and x as unit
draws, flip, blur, radius) from a ``torch.Generator``;
``apply_augment`` applies them. The JAX package draws them from its own
key (``jax.random.split`` into six), a different stream, so the two
packages augment with different draws from the same seed; given the same
draws, they give the same crops.

Tensors: images ``(B, 3, Hs, Ws)`` float32 in [0, 1], masks
``(B, Hs, Ws)`` int, ``valid_hw`` ``(B, 2)`` the valid (h, w) inside the
padded buffers, all on one device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def load_raw_batch(dataset, indices, *, buffer_hw: Tuple[int, int],
                   max_edge: int):
    """Host-side raw loading: each image through the dataset's ``_load``,
    resized so its longest edge is <= ``max_edge``, zero-padded into a
    static ``(len(indices), *buffer_hw)`` buffer. Returns numpy
    ``(images (n, bh, bw, 3) float32, masks (n, bh, bw) int32,
    valid_hw (n, 2) int32)``."""
    from PIL import Image
    bh, bw = buffer_hw
    n = len(indices)
    imgs = np.zeros((n, bh, bw, 3), np.float32)
    masks = np.zeros((n, bh, bw), np.int32)
    valid = np.zeros((n, 2), np.int32)
    for bi, i in enumerate(indices):
        img, mask = dataset._load(int(i))
        w, h = img.size
        scale = min(max_edge / max(h, w), 1.0)
        if scale < 1.0:
            nw, nh = int(w * scale), int(h * scale)
            img = img.resize((nw, nh), Image.BILINEAR)
            mask = mask.resize((nw, nh), Image.NEAREST)
            w, h = nw, nh
        ia = np.asarray(img, np.float32) / 255.0
        ma = dataset._mask_transform(np.asarray(mask).astype(np.int32))
        imgs[bi, :h, :w] = ia
        masks[bi, :h, :w] = ma
        valid[bi] = (h, w)
    return imgs, masks, valid


def _gather(img: torch.Tensor, yi: torch.Tensor,
            xi: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); yi/xi (B, h, w) integer coordinates, clamped into
    the image -> (B, C, h, w)."""
    b, c, h, w = img.shape
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
    out = img.reshape(b, c, h * w).gather(2, idx.expand(b, c, -1))
    return out.reshape((b, c) + tuple(yi.shape[1:]))


def _sample_bilinear(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); ys/xs (B, h, w) float source coordinates; 0
    outside the image."""
    h, w = img.shape[2], img.shape[3]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]

    def gather(yi, xi):
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[:, None]
        return _gather(img, yi.to(torch.int64), xi.to(torch.int64)) * inside

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _sample_nearest(mask: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    fill: int = 0) -> torch.Tensor:
    """mask (B, H, W); nearest read (round half to even), ``fill``
    outside."""
    h, w = mask.shape[1], mask.shape[2]
    yi = torch.round(ys).to(torch.int64)
    xi = torch.round(xs).to(torch.int64)
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    return torch.where(inside, _gather(mask[:, None], yi, xi)[:, 0], fill)


def _gauss_kernel(radius: torch.Tensor) -> torch.Tensor:
    """radius (B,) -> (B, 5) Gaussian taps, sigma = max(radius, 1e-3)."""
    sigma = torch.clamp(radius, min=1e-3)[:, None]
    off = torch.arange(-2.0, 3.0, dtype=radius.dtype, device=radius.device)
    k = torch.exp(-(off ** 2) / (2.0 * sigma ** 2))
    return k / k.sum(-1, keepdim=True)


def _blur(img: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W): the separable 5-tap blur, rows then columns, with
    edge padding; one radius per image."""
    k = _gauss_kernel(radius)[:, :, None, None, None]  # (B, 5, 1, 1, 1)
    h, w = img.shape[2], img.shape[3]
    rows = torch.clamp(torch.arange(-2, h + 2, device=img.device), 0, h - 1)
    x = img[:, :, rows]
    x = sum(k[:, i] * x[:, :, i:i + h] for i in range(5))
    cols = torch.clamp(torch.arange(-2, w + 2, device=img.device), 0, w - 1)
    x = x[:, :, :, cols]
    return sum(k[:, i] * x[:, :, :, i:i + w] for i in range(5))


def draw_augment_params(generator: Optional[torch.Generator], n: int, *,
                        base_size: int, scale_lo: float = 0.5,
                        scale_hi: float = 2.0,
                        device: torch.device = torch.device("cpu")
                        ) -> Dict[str, torch.Tensor]:
    """The six draws of each of ``n`` images, each a ``(n,)`` tensor:
    ``short`` ~ U(scale_lo, scale_hi) x base_size, ``u_y``/``u_x`` ~ U(0, 1)
    (the crop origin as a share of its range), ``flip`` and ``blur`` with
    p = 0.5, ``radius`` ~ U(0, 1)."""
    def u():
        return torch.rand((n,), generator=generator, device=device)
    lo, hi = scale_lo * base_size, scale_hi * base_size
    return {"short": lo + (hi - lo) * u(), "u_y": u(), "u_x": u(),
            "flip": u() < 0.5, "blur": u() < 0.5, "radius": u()}


def apply_augment(images: torch.Tensor, masks: torch.Tensor,
                  valid_hw: torch.Tensor, params: Dict[str, torch.Tensor], *,
                  crop_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The affine crop of ``_augment_one`` with the given draws: output
    pixel (i, j) reads the scaled image at (cy + i, cx + j), i.e. source
    ((cy + i) / scale, (cx + j) / scale), x mirrored in source space when
    flipped; the blur where drawn. Returns ``(B, 3, crop, crop)`` float32
    and ``(B, crop, crop)`` int64."""
    f32 = torch.float32
    h = valid_hw[:, 0].to(f32)
    w = valid_hw[:, 1].to(f32)
    scale = params["short"].to(f32) / torch.minimum(h, w)
    oh, ow = h * scale, w * scale
    cy = params["u_y"].to(f32) * torch.clamp(oh - crop_size, min=0.0)
    cx = params["u_x"].to(f32) * torch.clamp(ow - crop_size, min=0.0)
    ii = torch.arange(crop_size, dtype=f32, device=images.device)
    ys = (cy[:, None] + ii) / scale[:, None]
    xs = (cx[:, None] + ii) / scale[:, None]
    b = images.shape[0]
    ys2 = ys[:, :, None].expand(b, crop_size, crop_size)
    xs2 = xs[:, None, :].expand(b, crop_size, crop_size)
    xs2 = torch.where(params["flip"][:, None, None],
                      (w - 1.0)[:, None, None] - xs2, xs2)

    out_img = _sample_bilinear(images, ys2, xs2)
    out_mask = _sample_nearest(masks, ys2, xs2, fill=0).to(torch.int64)
    out_img = torch.where(params["blur"][:, None, None, None],
                          _blur(out_img, params["radius"].to(f32)), out_img)
    return out_img, out_mask


def augment_batch(images: torch.Tensor, masks: torch.Tensor,
                  valid_hw: torch.Tensor,
                  generator: Optional[torch.Generator], *, base_size: int,
                  crop_size: int, scale_lo: float = 0.5,
                  scale_hi: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched train augmentation on the images' device: the draws of
    ``draw_augment_params`` from ``generator``, then ``apply_augment``.
    Returns ``(B, 3, crop, crop)`` float32 and ``(B, crop, crop)``
    int64."""
    params = draw_augment_params(generator, images.shape[0],
                                 base_size=base_size, scale_lo=scale_lo,
                                 scale_hi=scale_hi, device=images.device)
    return apply_augment(images, masks, valid_hw, params,
                         crop_size=crop_size)


def jitter_factors(generator: Optional[torch.Generator], *,
                   brightness: float = 0.5, contrast: float = 0.5,
                   saturation: float = 0.5,
                   device: torch.device = torch.device("cpu")
                   ) -> torch.Tensor:
    """The three ColorJitter factors, each ~ U(max(0, 1 - f), 1 + f)
    (torchvision's convention)."""
    lo = torch.tensor([max(0.0, 1.0 - f) for f in
                       (brightness, contrast, saturation)], device=device)
    hi = torch.tensor([1.0 + f for f in (brightness, contrast, saturation)],
                      device=device)
    return lo + (hi - lo) * torch.rand((3,), generator=generator,
                                       device=device)


def apply_color_jitter(img: torch.Tensor, factors) -> torch.Tensor:
    """Brightness, then contrast, then saturation, on ``(..., 3, H, W)``
    in [0, 1] with the given three factors."""
    fb, fc, fs = factors[0], factors[1], factors[2]
    img = torch.clamp(img * fb, 0.0, 1.0)
    mean = img.mean(dim=(-3, -2, -1), keepdim=True)
    img = torch.clamp(mean + (img - mean) * fc, 0.0, 1.0)
    gray = (0.299 * img[..., 0, :, :] + 0.587 * img[..., 1, :, :]
            + 0.114 * img[..., 2, :, :])[..., None, :, :]
    return torch.clamp(gray + (img - gray) * fs, 0.0, 1.0)


def color_jitter(img: torch.Tensor, generator: Optional[torch.Generator], *,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> torch.Tensor:
    """On-device ColorJitter(brightness, contrast, saturation), the one
    live transform of the reference's augmentation library
    (``semseg/datasets/augmentations.py:402-419``), offered as an option
    as in the JAX package; draws its factors from ``generator``."""
    return apply_color_jitter(img, jitter_factors(
        generator, brightness=brightness, contrast=contrast,
        saturation=saturation, device=img.device))
