"""Plain ViT encoder of the Segmenter family (NCHW image in, tokens out).

Port of ``robseg_tpu/models/vit.py``: patch-embed conv, a
class token (and a distillation token for the DeiT variants), an additive
position embedding resized bilinearly when the token grid differs from the
native one, pre-norm transformer blocks and a final LayerNorm. Module and
parameter names are the reference ``state_dict``'s
(``encoder.patch_embed.proj``, ``encoder.blocks.{i}.attn.qkv``, ...), the
keys ``robseg_tpu/convert/torch2jax.py::convert_vit_encoder`` reads. In
train mode the blocks run DropPath at ``np.linspace(0, drop_path_rate,
n_layers)`` and, where ``dropout > 0``, dropout after the position
embedding, the attention projection, GELU and ``fc2`` (JAX ``:57-97``).

Attention is written out as ``(q @ k^T) * head_dim**-0.5``, softmax, then
``@ v``: the reference's order, which the JAX module keeps on purpose
(``vit.py:66-71``). ``scaled_dot_product_attention`` scales q before the
product and is not used. Every LayerNorm has torch's eps of 1e-5.

No Pallas kernel runs in these modules in the JAX package; their products
go through ``ops.precision`` (plain ``torch.matmul``, ``F.linear`` and
``conv2d`` unless the train CLI's bf16 products are on). The layers with
parameters compute in JAX's promoted dtype (``models/layers.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.models.layers import (Conv2d, DropPath, Dropout, LayerNorm,
                                        Linear, trunc_normal_)
from robseg_torch.ops import precision
from robseg_torch.ops.resize import resize_bilinear

LN_EPS = 1e-5


def resize_pos_embed(posemb: torch.Tensor, grid_old, grid_new,
                     num_extra_tokens: int) -> torch.Tensor:
    """Bilinearly resample the grid part of a (1, N, D) position embedding
    (align_corners=False); the class/distillation tokens stay."""
    tok = posemb[:, :num_extra_tokens]
    grid = posemb[0, num_extra_tokens:]
    if grid_old is None:
        g = int(math.sqrt(grid.shape[0]))
        grid_old = (g, g)
    gh, gw = grid_new
    grid = grid.reshape(grid_old[0], grid_old[1], -1).permute(2, 0, 1)
    grid = resize_bilinear(grid[None], (gh, gw))[0]
    grid = grid.permute(1, 2, 0).reshape(1, gh * gw, -1)
    return torch.cat([tok, grid], dim=1)


class Attention(nn.Module):
    """Multi-head self-attention, the reference's order of operations."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]              # (b, heads, n, hd)
        attn = precision.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
        attn = attn.softmax(dim=-1)
        y = precision.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.drop(self.proj(y))


class FeedForward(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)
        trunc_normal_(self.fc1.weight)
        trunc_normal_(self.fc2.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 drop_path: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, dropout)
        self.mlp = FeedForward(dim, mlp_dim, dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchEmbedding(nn.Module):
    """``patch_embed.proj``: a patch-size conv with stride patch-size."""

    def __init__(self, patch_size: int, d_model: int, channels: int = 3):
        super().__init__()
        self.proj = Conv2d(channels, d_model, patch_size, stride=patch_size)

    def forward(self, im: torch.Tensor) -> torch.Tensor:
        return self.proj(im)


class VisionTransformer(nn.Module):
    """ViT encoder returning the whole token sequence, (B, N, D): the class
    (and distillation) tokens first, then the grid row by row.
    ``image_size`` fixes the native position-embedding grid; another input
    size resamples it at each call."""

    def __init__(self, image_size=(512, 512), patch_size: int = 16,
                 n_layers: int = 12, d_model: int = 384, d_ff: int = 1536,
                 n_heads: int = 6, drop_path_rate: float = 0.1,
                 distilled: bool = False, dropout: float = 0.0):
        super().__init__()
        self.patch_size = patch_size
        self.d_model = d_model
        self.distilled = distilled
        self.native_grid = (image_size[0] // patch_size,
                            image_size[1] // patch_size)
        self.num_extra = 1 + int(distilled)
        self.patch_embed = PatchEmbedding(patch_size, d_model)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        if distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, d_model))
        n_native = self.native_grid[0] * self.native_grid[1] + self.num_extra
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, n_native, d_model)))
        self.drop = Dropout(dropout)
        dpr = np.linspace(0.0, drop_path_rate, n_layers)
        self.blocks = nn.ModuleList([
            Block(d_model, n_heads, d_ff, float(dpr[i]), dropout)
            for i in range(n_layers)])
        self.norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, im: torch.Tensor) -> torch.Tensor:
        b = im.shape[0]
        x = self.patch_embed(im)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        toks = [self.cls_token.expand(b, -1, -1)]
        if self.distilled:
            toks.append(self.dist_token.expand(b, -1, -1))
        x = torch.cat(toks + [x], dim=1)
        pos = self.pos_embed
        if x.shape[1] != pos.shape[1]:
            pos = resize_pos_embed(pos, self.native_grid, (gh, gw),
                                   self.num_extra)
        x = self.drop(x + pos)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)
