"""Everything a run feeds the program and the reference, made from
``--seed`` on the device: the weights (one state dict under the reference
``state_dict`` names, handed to both sides), the images and the labels.

Each quantity draws from its own generator, seeded from ``--seed`` and a
tag, so the same seed gives the same inputs whatever else a run draws.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed from ``seed`` (any non-negative integer) and ``tag``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64),
                                   zlib.crc32(tag.encode())])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _leaf_law(name: str, shape) -> tuple:
    """(shift, scale, absolute) of a leaf's values: shift + scale * z, z
    standard normal (its magnitude where ``absolute``)."""
    if name.endswith("running_var"):
        return 1.0, 0.1, True
    if name.endswith("running_mean"):
        return 0.0, 0.1, False
    if any(k in name for k in ("pos_embed", "cls_token", "cls_emb")):
        return 0.0, 0.02, False
    if name.endswith("gamma"):
        return 0.0, 0.5, False
    if len(shape) >= 2:
        return 0.0, nets.fan_in(shape) ** -0.5, False
    if name.endswith("bias"):
        return 0.0, 0.02, False
    return 1.0, 0.1, False  # norm scales


def state_dict(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights in float32 from one normal draw:
    products' weights N(0, 1/fan_in), norm scales 1 + 0.1 z, biases
    0.02 z, layer scales 0.5 z, embeddings 0.02 z, BatchNorm statistics
    0.1 z and 1 + 0.1 |z|."""
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype)
                  for k, v in nets.build(cfg).state_dict().items()}
    floats = [(k, s) for k, (s, dt) in shapes.items() if dt.is_floating_point]
    counts = torch.tensor([s.numel() for _, s in floats], device=device)
    laws = torch.tensor([_leaf_law(k, s) for k, s in floats],
                        dtype=torch.float32, device=device)
    shift, scale, absolute = (torch.repeat_interleave(laws[:, i], counts)
                              for i in range(3))
    z = torch.randn(int(counts.sum()), generator=generator(seed, "weights",
                                                           device),
                    device=device)
    flat = shift + scale * torch.where(absolute > 0, z.abs(), z)
    out, at = {}, 0
    for k, s in floats:
        out[k] = flat[at:at + s.numel()].view(s)
        at += s.numel()
    for k, (s, dt) in shapes.items():
        if k not in out:
            out[k] = torch.zeros(s, dtype=dt, device=device)
    return out


def images(seed: int, tag: str, b: int, hw, device) -> torch.Tensor:
    """(b, 3, H, W) images in [0, 1]: smooth regions from a coarse grid
    plus fine texture."""
    g = generator(seed, tag, device)
    h, w = hw
    coarse = torch.rand((b, 3, -(-h // 16), -(-w // 16)), generator=g,
                        device=device)
    fine = torch.rand((b, 3, h, w), generator=g, device=device)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False)
    return torch.clamp(0.85 * smooth + 0.15 * fine, 0.0, 1.0)


def ignore_mask(seed: int, tag: str, b: int, hw, share: float, device):
    """(b, H, W) bool: blocks of 16 x 16 pixels marked ignored with
    probability ``share``."""
    g = generator(seed, tag, device)
    h, w = hw
    u = torch.rand((b, 1, -(-h // 16), -(-w // 16)), generator=g,
                   device=device)
    return F.interpolate((u < share).float(), size=(h, w),
                         mode="nearest")[:, 0] > 0
