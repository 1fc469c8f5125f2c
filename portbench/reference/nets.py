"""The plain reference networks: ConvNeXt-T (CvSt stem) + UperNet, and
Segmenter ViT-S/16 with its mask-transformer decoder.

Plain PyTorch in float32, written from the published descriptions (ConvNeXt,
Liu et al. 2022; UperNet, Xiao et al. 2018; Segmenter, Strudel et al. 2021)
and the parameter layout of the reference ``state_dict`` the robust models of
arXiv:2306.12941 ship, so that one state dict loads into this module and into
the program under test alike. No kernel, no fused path, no cache: every
convolution and product is a ``torch.nn.functional`` call, every resize is
``F.interpolate``. The caller turns TF32 off (``portbench.reference.strict``).

Inference only, as an attack evaluates a model: BatchNorm normalises with its
running statistics, and stochastic depth keeps every sample (it holds no
parameter, so the modules leave it out).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor, align_corners=False."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=False)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        1, self.groups)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Norm(nn.Module):
    """LayerNorm over the last axis."""

    def __init__(self, c, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                            self.eps)


class ChannelNorm(Norm):
    """LayerNorm over the channel axis of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.eps = eps

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mean, var = self.running_mean, self.running_var
        y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


class ConvModule(nn.Module):
    """Conv (no bias), BatchNorm, ReLU."""

    def __init__(self, cin, cout, k=1, padding=0):
        super().__init__()
        self.conv = Conv(cin, cout, k, padding=padding, bias=False)
        self.batch_norm = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.batch_norm(self.conv(x)))


class ConvNeXtBlock(nn.Module):
    """x + gamma * W2 GELU(W1 LN(dwconv7x7(x))), channels-last x."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim)
        self.norm = Norm(dim, 1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return x + self.gamma * y


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int], dims: Sequence[int]):
        super().__init__()
        half = dims[0] // 2
        stem = nn.Module()
        stem.stem = nn.Sequential(
            Conv(3, half, 3, stride=2, padding=1), ChannelNorm(half, 1e-6),
            nn.GELU(), Conv(half, dims[0], 3, stride=2, padding=1),
            ChannelNorm(dims[0], 1e-6), nn.GELU())
        self.downsample_layers = nn.ModuleList([stem] + [
            nn.Sequential(Norm(dims[i - 1], 1e-6),
                          Conv(dims[i - 1], dims[i], 2, stride=2))
            for i in range(1, 4)])
        self.stages = nn.ModuleList([
            nn.Sequential(*[ConvNeXtBlock(dims[i]) for _ in range(depths[i])])
            for i in range(4)])
        for i in range(4):
            self.add_module(f"norm{i}", Norm(dims[i], 1e-6))

    def forward(self, x):
        outs = []
        for i in range(4):
            if i == 0:
                x = self.downsample_layers[0].stem(x)
            else:
                ln, conv = self.downsample_layers[i]
                x = conv(ln(x).permute(0, 3, 1, 2))
            x = self.stages[i](x.permute(0, 2, 3, 1))
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
        return outs


class PoolConv(nn.Module):
    """Adaptive average pooling to ``scale`` x ``scale``, then a 1x1
    ConvModule (slot ``1``, the reference layout)."""

    def __init__(self, scale, cin, cout):
        super().__init__()
        self.scale = scale
        self.add_module("1", ConvModule(cin, cout, 1))

    def forward(self, x):
        return getattr(self, "1")(F.adaptive_avg_pool2d(x, self.scale))


class UperNetHead(nn.Module):
    def __init__(self, n_cls, in_channels, channels, pool_scales):
        super().__init__()
        self.psp_modules = nn.ModuleList([
            PoolConv(s, in_channels[-1], channels) for s in pool_scales])
        self.bottleneck = ConvModule(
            in_channels[-1] + len(pool_scales) * channels, channels, 3, 1)
        self.lateral_convs = nn.ModuleList([
            ConvModule(c, channels, 1) for c in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([
            ConvModule(channels, channels, 3, 1) for _ in in_channels[:-1]])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3, 1)
        self.classifier = Conv(channels, n_cls, 1)

    def forward(self, feats):
        top = feats[-1]
        psp = self.bottleneck(torch.cat(
            [top] + [resize(m(top), top.shape[-2:]) for m in self.psp_modules],
            dim=1))
        lat = [c(feats[i]) for i, c in enumerate(self.lateral_convs)] + [psp]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize(lat[i], lat[i - 1].shape[-2:])
        outs = [c(lat[i]) for i, c in enumerate(self.fpn_convs)] + [lat[-1]]
        size = outs[0].shape[-2:]
        outs = [outs[0]] + [resize(o, size) for o in outs[1:]]
        return self.classifier(self.fpn_bottleneck(torch.cat(outs, dim=1)))


class FCNHead(nn.Module):
    def __init__(self, n_cls, cin, channels, in_index):
        super().__init__()
        self.in_index = in_index
        self.convs = nn.ModuleList([ConvModule(cin, channels, 3, 1)])
        self.classifier = Conv(channels, n_cls, 1)

    def forward(self, feats):
        return self.classifier(self.convs[0](feats[self.in_index]))


class UperNet(nn.Module):
    """Logits at the input size. The auxiliary head only trains, so the
    forward leaves it out; it is here for the state dict's layout."""

    def __init__(self, cfg: dict):
        super().__init__()
        a = cfg["arch"]
        self.backbone = ConvNeXt(a["depths"], a["dims"])
        self.decode_head = UperNetHead(cfg["n_cls"], a["dims"],
                                       a["head_channels"], a["pool_scales"])
        aux = a["aux_in_index"]
        self.auxiliary_head = FCNHead(cfg["n_cls"], a["dims"][aux],
                                      a["aux_channels"], aux)

    def forward(self, x):
        return resize(self.decode_head(self.backbone(x)), x.shape[-2:])


# ---------------------------------------------------------------- Segmenter

class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block (LayerNorm eps 1e-5)."""

    def __init__(self, dim, heads, hidden):
        super().__init__()
        self.norm1 = Norm(dim, 1e-5)
        self.norm2 = Norm(dim, 1e-5)
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = Conv(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x)


class ViT(nn.Module):
    def __init__(self, a: dict, image_size):
        super().__init__()
        d, p = a["d_model"], a["patch_size"]
        self.patch_size = p
        self.native = (image_size[0] // p, image_size[1] // p)
        self.patch_embed = PatchEmbed(p, d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.native[0] * self.native[1] + 1, d))
        self.blocks = nn.ModuleList([
            Block(d, a["n_heads"], a["d_ff"]) for _ in range(a["n_layers"])])
        self.norm = Norm(d, 1e-5)

    def forward(self, im):
        x = self.patch_embed(im)
        gh, gw = x.shape[-2:]
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1),
                       x.flatten(2).transpose(1, 2)], dim=1)
        pos = self.pos_embed
        if (gh, gw) != self.native:
            grid = pos[0, 1:].reshape(*self.native, -1).permute(2, 0, 1)
            grid = resize(grid[None], (gh, gw))[0].permute(1, 2, 0)
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], 1)
        x = x + pos
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class MaskTransformer(nn.Module):
    def __init__(self, n_cls, a: dict):
        super().__init__()
        d = a["d_model"]
        self.n_cls = n_cls
        self.proj_dec = Dense(d, d)
        self.cls_emb = nn.Parameter(torch.empty(1, n_cls, d))
        self.blocks = nn.ModuleList([
            Block(d, d // 64, a["d_ff"]) for _ in range(a["decoder_layers"])])
        self.decoder_norm = Norm(d, 1e-5)
        self.proj_patch = nn.Parameter(torch.empty(d, d))
        self.proj_classes = nn.Parameter(torch.empty(d, d))
        self.mask_norm = Norm(n_cls, 1e-5)

    def forward(self, x, gh):
        x = self.proj_dec(x)
        x = torch.cat([x, self.cls_emb.expand(x.shape[0], -1, -1)], 1)
        for blk in self.blocks:
            x = blk(x)
        x = self.decoder_norm(x)
        patches = x[:, :-self.n_cls] @ self.proj_patch
        classes = x[:, -self.n_cls:] @ self.proj_classes
        patches = patches / patches.norm(dim=-1, keepdim=True)
        classes = classes / classes.norm(dim=-1, keepdim=True)
        masks = self.mask_norm(patches @ classes.transpose(1, 2))
        b, n, k = masks.shape
        return masks.transpose(1, 2).reshape(b, k, gh, n // gh)


class Segmenter(nn.Module):
    """Pad to a multiple of the patch, encode, decode, resize, unpad."""

    def __init__(self, cfg: dict):
        super().__init__()
        a = cfg["arch"]
        self.patch_size = a["patch_size"]
        self.encoder = ViT(a, cfg["image_size"])
        self.decoder = MaskTransformer(cfg["n_cls"], a)

    def forward(self, im):
        h0, w0 = im.shape[-2:]
        p = self.patch_size
        im = F.pad(im, (0, (-w0) % p, 0, (-h0) % p))
        h, w = im.shape[-2:]
        x = self.encoder(im)[:, 1:]
        masks = resize(self.decoder(x, h // p), (h, w))
        return masks[..., :h0, :w0]


NETS = {"upernet": UperNet, "segmenter": Segmenter}


def build(cfg: dict) -> nn.Module:
    """The reference network of a configuration file's ``reference`` key,
    its parameters uninitialised (``load_state_dict`` fills them)."""
    return NETS[cfg["reference"]](cfg)


def fan_in(shape) -> int:
    return math.prod(shape[1:])
