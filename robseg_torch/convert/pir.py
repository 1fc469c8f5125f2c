"""PIR initialisation: robust-ImageNet checkpoints into the port's models.

The counterpart of ``tools/train.py:165-206`` (``MODEL.PRETRAINED``), which
goes through ``robseg_tpu/convert/torch2jax.py``. Here a checkpoint's keys
are renamed onto the port's ``state_dict`` (the layouts match tensor for
tensor; the ViT's position embedding is resampled):
  * ``convnext_cvst_backbone``: the ConvNeXt CvSt pretraining layout
    (``stem.stem.{i}``, ``stages.{l}.downsample.{p}``,
    ``stages.{j}.blocks.{k}.conv_dw`` / ``mlp.fc1`` / ``mlp.fc2``;
    ``torch2jax.py:81-150`` with ``cvst_ckpt_layout=True``) onto
    ``backbone.*`` of UperNet;
  * ``vit_encoder``: a timm ViT onto ``encoder.*`` of the Segmenter, the
    position embedding resampled to the model's native grid
    (``torch2jax.py:326-352``);
  * ``resnet_backbone``: a torchvision-style robust ResNet-50 (BatchNorm
    statistics included) onto PSPNet's ``layer0`` .. ``layer4`` or
    ``backbone.*`` of the DeepLab and DDCAT models
    (``torch2jax.py:257-294``).
Keys the JAX converters do not read (classifier heads) are left out.
"""

from __future__ import annotations

from typing import Dict

import torch

from robseg_torch.models.convnext import CONVNEXT_SETTINGS
from robseg_torch.models.vit import resize_pos_embed

Tensors = Dict[str, torch.Tensor]
_BN = ("weight", "bias", "running_mean", "running_var")


def strip_prefixes(sd: Tensors) -> Tensors:
    """Drop the ``module.`` / ``base_model.`` prefixes of wrapped models."""
    return {k.replace("module.", "").replace("base_model.", ""): v
            for k, v in sd.items()}


def read_checkpoint(path: str) -> Tensors:
    """A ``.pth``, unnested from deit/mmcv's ``model`` / ``state_dict``
    key, prefixes stripped."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict"):
        if key in raw and isinstance(raw[key], dict):
            raw = raw[key]
    return strip_prefixes(raw)


def convnext_cvst_backbone(sd: Tensors, variant: str) -> Tensors:
    """The CvSt pretraining layout -> UperNet's ``backbone.*`` keys."""
    depths = CONVNEXT_SETTINGS[variant][0]
    out: Tensors = {}

    def take(dst, src, names=("weight", "bias")):
        for n in names:
            out[f"backbone.{dst}.{n}"] = sd[f"{src}.{n}"]
    for i in (0, 1, 3, 4):
        take(f"downsample_layers.0.stem.{i}", f"stem.stem.{i}")
    for layer in range(1, 4):
        for p in (0, 1):
            take(f"downsample_layers.{layer}.{p}",
                 f"stages.{layer}.downsample.{p}")
    for j in range(4):
        for k in range(depths[j]):
            src, dst = f"stages.{j}.blocks.{k}", f"stages.{j}.{k}"
            out[f"backbone.{dst}.gamma"] = sd[f"{src}.gamma"]
            for a, b in (("conv_dw", "dwconv"), ("norm", "norm"),
                         ("mlp.fc1", "pwconv1"), ("mlp.fc2", "pwconv2")):
                take(f"{dst}.{b}", f"{src}.{a}")
    for i in range(4):  # full-model checkpoints only
        if f"norm{i}.weight" in sd:
            take(f"norm{i}", f"norm{i}")
    return out


def vit_encoder(sd: Tensors, n_layers: int, target_grid) -> Tensors:
    """A ViT state_dict -> the Segmenter's ``encoder.*`` keys, the position
    embedding resampled to ``target_grid`` where its length differs."""
    out: Tensors = {}
    for n in ("weight", "bias"):
        out[f"encoder.patch_embed.proj.{n}"] = sd[f"patch_embed.proj.{n}"]
        out[f"encoder.norm.{n}"] = sd[f"norm.{n}"]
    out["encoder.cls_token"] = sd["cls_token"]
    num_extra = 1 + ("dist_token" in sd)
    if "dist_token" in sd:
        out["encoder.dist_token"] = sd["dist_token"]
    pos = sd["pos_embed"]
    if pos.shape[1] != target_grid[0] * target_grid[1] + num_extra:
        pos = resize_pos_embed(pos, None, target_grid, num_extra)
    out["encoder.pos_embed"] = pos
    for i in range(n_layers):
        for layer in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                      "mlp.fc2"):
            for n in ("weight", "bias"):
                k = f"blocks.{i}.{layer}.{n}"
                out[f"encoder.{k}"] = sd[k]
    return out


def resnet_backbone(sd: Tensors, deep_base: bool,
                    pspnet_layout: bool) -> Tensors:
    """A ResNet-50 state_dict -> PSPNet's ``layer0.{0,1,3,4,6,7}`` stem and
    ``layer{1..4}`` (``pspnet_layout``), or ``backbone.*`` keys."""
    out: Tensors = {}
    pre = "" if pspnet_layout else "backbone."
    for i in range(1, 4 if deep_base else 2):
        conv, bn = ((f"layer0.{3 * i - 3}", f"layer0.{3 * i - 2}")
                    if pspnet_layout else (f"backbone.conv{i}",
                                           f"backbone.bn{i}"))
        out[f"{conv}.weight"] = sd[f"conv{i}.weight"]
        for n in _BN:
            out[f"{bn}.{n}"] = sd[f"bn{i}.{n}"]
    for s, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            src = f"layer{s}.{b}"
            for c in (1, 2, 3):
                out[f"{pre}{src}.conv{c}.weight"] = sd[f"{src}.conv{c}.weight"]
                for n in _BN:
                    out[f"{pre}{src}.bn{c}.{n}"] = sd[f"{src}.bn{c}.{n}"]
            if f"{src}.downsample.0.weight" in sd:
                out[f"{pre}{src}.downsample.0.weight"] = \
                    sd[f"{src}.downsample.0.weight"]
                for n in _BN:
                    out[f"{pre}{src}.downsample.1.{n}"] = \
                        sd[f"{src}.downsample.1.{n}"]
    return out


def pir_state_dict(model_name: str, backbone: str, module: torch.nn.Module,
                   sd: Tensors, deep_base: bool) -> Tensors:
    """The checkpoint's part of ``module``'s ``state_dict``, per family."""
    if model_name == "UperNetForSemanticSegmentation":
        return convnext_cvst_backbone(sd, backbone.split("-")[1])
    if model_name == "SegMenter":
        return vit_encoder(sd, len(module.encoder.blocks),
                           module.encoder.native_grid)
    if model_name.startswith(("PSPNet", "DeepLabV3")):
        return resnet_backbone(sd, deep_base, model_name == "PSPNet")
    raise ValueError(f"no PIR-init path for {model_name!r}")


def load_pir(module: torch.nn.Module, model_name: str, backbone: str,
             path: str, deep_base: bool) -> int:
    """Load a robust-ImageNet checkpoint into ``module``'s backbone or
    encoder; every mapped key must exist in the module. Returns the count
    of tensors loaded."""
    sd = pir_state_dict(model_name, backbone, module, read_checkpoint(path),
                        deep_base)
    own = module.state_dict()
    missing = sorted(set(sd) - set(own))
    if missing:
        raise KeyError(f"PIR init: keys not in the model: {missing[:8]}")
    module.load_state_dict(sd, strict=False)
    return len(sd)
