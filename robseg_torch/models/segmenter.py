"""Segmenter: the ViT encoder and a mask-transformer (or linear) decoder.

Port of ``robseg_tpu/models/segmenter.py``, on NCHW tensors:

  * ``MaskTransformer``: project the patch tokens, append the learned
    class embeddings, transformer blocks, LayerNorm, split patches and
    classes, project both, L2-normalise, masks = patches . classes^T,
    LayerNorm over the classes, back to the token grid;
  * ``SegMenter``: pad the input to a multiple of the patch size, encode,
    drop the class/distillation tokens, decode, resize bilinearly
    (align_corners=False) to the padded size and cut the padding off.

In train mode the encoder runs DropPath (rate ``drop_path_rate``
spread by linspace over its blocks, 0.1 in the zoo) with the encoder
``dropout`` (0 in the zoo), and the decoder's blocks run dropout 0.1 and
no DropPath: the JAX module's defaults (``segmenter.py:53-70``).

Module and parameter names are the reference ``state_dict``'s
(``decoder.proj_dec``, ``decoder.cls_emb``, ``decoder.proj_patch``, ...),
the keys ``robseg_tpu/convert/torch2jax.py::convert_segmenter`` reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robseg_torch.models.layers import LayerNorm, Linear, trunc_normal_
from robseg_torch.models.vit import LN_EPS, Block, VisionTransformer
from robseg_torch.ops import precision
from robseg_torch.ops.resize import resize_bilinear


def _to_grid(x: torch.Tensor, gh: int) -> torch.Tensor:
    """(B, gh*gw, K) tokens -> (B, K, gh, gw)."""
    b, n, k = x.shape
    return x.transpose(1, 2).reshape(b, k, gh, n // gh)


class DecoderLinear(nn.Module):
    """One linear layer from the patch tokens to the class scores."""

    def __init__(self, n_cls: int, patch_size: int, d_encoder: int):
        super().__init__()
        self.patch_size = patch_size
        self.head = Linear(d_encoder, n_cls)

    def forward(self, x: torch.Tensor, im_size) -> torch.Tensor:
        return _to_grid(self.head(x), im_size[0] // self.patch_size)


class MaskTransformer(nn.Module):
    """The mask-transformer decoder."""

    def __init__(self, n_cls: int, patch_size: int, d_encoder: int,
                 n_layers: int = 2, d_model: int = 384, n_heads: int = 6,
                 d_ff: int = 1536, drop_path_rate: float = 0.0,
                 dropout: float = 0.1):
        super().__init__()
        self.n_cls = n_cls
        self.patch_size = patch_size
        scale = d_model ** -0.5
        self.proj_dec = Linear(d_encoder, d_model)
        trunc_normal_(self.proj_dec.weight)
        self.cls_emb = nn.Parameter(trunc_normal_(
            torch.empty(1, n_cls, d_model)))
        dpr = np.linspace(0.0, drop_path_rate, n_layers)
        self.blocks = nn.ModuleList([
            Block(d_model, n_heads, d_ff, float(dpr[i]), dropout)
            for i in range(n_layers)])
        self.decoder_norm = LayerNorm(d_model, eps=LN_EPS)
        self.proj_patch = nn.Parameter(scale * torch.randn(d_model, d_model))
        self.proj_classes = nn.Parameter(scale * torch.randn(d_model,
                                                             d_model))
        self.mask_norm = LayerNorm(n_cls, eps=LN_EPS)

    def forward(self, x: torch.Tensor, im_size) -> torch.Tensor:
        x = self.proj_dec(x)
        x = torch.cat([x, self.cls_emb.expand(x.shape[0], -1, -1)], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.decoder_norm(x)
        patches, cls_feat = x[:, :-self.n_cls], x[:, -self.n_cls:]
        patches = precision.matmul(patches, self.proj_patch)
        cls_feat = precision.matmul(cls_feat, self.proj_classes)
        patches = patches / patches.norm(dim=-1, keepdim=True)
        cls_feat = cls_feat / cls_feat.norm(dim=-1, keepdim=True)
        masks = self.mask_norm(precision.matmul(patches,
                                                cls_feat.transpose(1, 2)))
        return _to_grid(masks, im_size[0] // self.patch_size)


class SegMenter(nn.Module):
    """The full Segmenter: ``forward(im)`` on NCHW images returns NCHW class
    scores at the input size."""

    def __init__(self, n_cls: int, image_size=(512, 512),
                 patch_size: int = 16, n_layers: int = 12,
                 d_model: int = 384, n_heads: int = 6,
                 drop_path_rate: float = 0.1, distilled: bool = False,
                 decoder_name: str = "mask_transformer",
                 decoder_n_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        self.patch_size = patch_size
        self.num_extra = 1 + int(distilled)
        self.encoder = VisionTransformer(
            image_size=image_size, patch_size=patch_size, n_layers=n_layers,
            d_model=d_model, d_ff=4 * d_model, n_heads=n_heads,
            drop_path_rate=drop_path_rate, distilled=distilled,
            dropout=dropout)
        if decoder_name == "mask_transformer":
            self.decoder = MaskTransformer(
                n_cls, patch_size, d_encoder=d_model,
                n_layers=decoder_n_layers, d_model=d_model,
                n_heads=d_model // 64, d_ff=4 * d_model)
        elif decoder_name == "linear":
            self.decoder = DecoderLinear(n_cls, patch_size, d_model)
        else:
            raise ValueError(f"Unknown decoder: {decoder_name}")

    def forward(self, im: torch.Tensor) -> torch.Tensor:
        h_ori, w_ori = im.shape[-2:]
        ps = self.patch_size
        pad_h, pad_w = (-h_ori) % ps, (-w_ori) % ps
        if pad_h or pad_w:
            im = F.pad(im, (0, pad_w, 0, pad_h))
        h, w = im.shape[-2:]
        x = self.encoder(im)[:, self.num_extra:]
        masks = resize_bilinear(self.decoder(x, (h, w)), (h, w))
        return masks[..., :h_ori, :w_ori]
