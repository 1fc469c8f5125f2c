"""JAX (Flax) model variables -> the port's ``state_dict``.

For UperNet, PSPNet and Segmenter the exact inverses of
``robseg_tpu/convert/torch2jax.py``'s ``convert_upernet`` (plain ConvNeXt
layout), ``convert_pspnet`` and ``convert_segmenter``: the state dicts
have the reference key names those read, so a reference ``.pth`` loads
into the port with ``strict=True``. The JAX package has no converter for
PSPNet-DDCAT, DeepLabV3 and DeepLabV3-DDCAT; for them the port's module
names follow the JAX parameter tree (``models/pspnet.py``). Layout maps,
JAX -> PyTorch:

  conv ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``; depthwise ``(7, 7, 1, C)``
  -> ``(C, 1, 7, 7)``; dense ``(I, O)`` -> ``(O, I)``; LayerNorm/BatchNorm
  ``scale`` -> ``weight``; BatchNorm ``mean``/``var`` ->
  ``running_mean``/``running_var`` (plus ``num_batches_tracked = 0``, which
  PyTorch's BatchNorm keeps in its state).

The input is numpy trees (``params``, ``batch_stats``), so this module needs
no JAX; ``npz_state_dict`` reads them from a JAX trainer's ``.npz`` files
(``save_params_npz``: ``/``-joined key paths, the BatchNorm statistics in
a ``.stats.npz`` sibling).
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from robseg_torch.models.convnext import CONVNEXT_SETTINGS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _lin(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _ln(sd, dst: str, node) -> None:
    sd[f"{dst}.weight"] = _t(node["scale"])
    sd[f"{dst}.bias"] = _t(node["bias"])


def _conv_bias(sd, dst: str, node) -> None:
    sd[f"{dst}.weight"] = _conv(node["kernel"])
    sd[f"{dst}.bias"] = _t(node["bias"])


def _bn(sd, dst: str, p, s) -> None:
    """A flax BatchNorm (``scale``, ``bias``; ``mean``, ``var``) ->
    ``{dst}.weight/bias/running_mean/running_var/num_batches_tracked``."""
    _ln(sd, dst, p)
    sd[f"{dst}.running_mean"] = _t(s["mean"])
    sd[f"{dst}.running_var"] = _t(s["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv_module(sd, dst: str, p, s) -> None:
    sd[f"{dst}.conv.weight"] = _conv(p["conv"]["kernel"])
    _bn(sd, f"{dst}.batch_norm", p["bn"], s["bn"])


def _backbone(sd, p, variant: str) -> None:
    depths = CONVNEXT_SETTINGS[variant][0]
    pre = "backbone"
    if "CVST" in variant:
        st = p["stem_cvst"]
        stem = f"{pre}.downsample_layers.0.stem"
        _conv_bias(sd, f"{stem}.0", st["conv0"])
        _ln(sd, f"{stem}.1", st["norm0"])
        _conv_bias(sd, f"{stem}.3", st["conv1"])
        _ln(sd, f"{stem}.4", st["norm1"])
    else:
        _conv_bias(sd, f"{pre}.downsample_layers.0.0", p["stem"]["conv"])
        _ln(sd, f"{pre}.downsample_layers.0.1", p["stem"]["norm"])
    for i in range(1, 4):
        ds = f"{pre}.downsample_layers.{i}"
        _ln(sd, f"{ds}.0", p[f"downsample_norm{i}"])
        _conv_bias(sd, f"{ds}.1", p[f"downsample_conv{i}"])
    for j in range(4):
        for k in range(depths[j]):
            b, src = f"{pre}.stages.{j}.{k}", p[f"stage{j}_block{k}"]
            sd[f"{b}.gamma"] = _t(src["gamma"])
            _conv_bias(sd, f"{b}.dwconv", src["dwconv"])
            _ln(sd, f"{b}.norm", src["norm"])
            sd[f"{b}.pwconv1.weight"] = _lin(src["pwconv1"]["kernel"])
            sd[f"{b}.pwconv1.bias"] = _t(src["pwconv1"]["bias"])
            sd[f"{b}.pwconv2.weight"] = _lin(src["pwconv2"]["kernel"])
            sd[f"{b}.pwconv2.bias"] = _t(src["pwconv2"]["bias"])
    for i in range(4):
        _ln(sd, f"{pre}.norm{i}", p[f"norm{i}"])


def upernet_state_dict_from_jax(params: Dict, batch_stats: Dict,
                                variant: str) -> Dict[str, torch.Tensor]:
    """UperNet ``(params, batch_stats)`` -> ``state_dict`` that
    ``UperNetForSemanticSegmentation(variant, K).load_state_dict`` takes
    with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    _backbone(sd, params["backbone"], variant)
    dp, ds = params["decode_head"], batch_stats["decode_head"]
    dh = "decode_head"
    for i in range(4):
        _conv_module(sd, f"{dh}.psp_modules.{i}.1", dp[f"psp_block{i}"],
                     ds[f"psp_block{i}"])
    _conv_module(sd, f"{dh}.bottleneck", dp["bottleneck"], ds["bottleneck"])
    for i in range(3):
        _conv_module(sd, f"{dh}.lateral_convs.{i}", dp[f"lateral{i}"],
                     ds[f"lateral{i}"])
        _conv_module(sd, f"{dh}.fpn_convs.{i}", dp[f"fpn{i}"], ds[f"fpn{i}"])
    _conv_module(sd, f"{dh}.fpn_bottleneck", dp["fpn_bottleneck"],
                 ds["fpn_bottleneck"])
    _conv_bias(sd, f"{dh}.classifier", dp["classifier"])
    ap, as_ = params["auxiliary_head"], batch_stats["auxiliary_head"]
    _conv_module(sd, "auxiliary_head.convs.0", ap["conv0"], as_["conv0"])
    _conv_bias(sd, "auxiliary_head.classifier", ap["classifier"])
    return sd


def _blocks(p) -> list:
    """The ``layer{s}_block{b}`` names of a ResNet subtree, as (s, b)."""
    keys = [re.fullmatch(r"layer(\d)_block(\d+)", k) for k in p]
    return sorted((int(m[1]), int(m[2])) for m in keys if m)


def _resnet(sd, p, s, stem: list, pre: str) -> None:
    """``ResNetStages`` variables -> ``{pre}layer{s}.{b}.*``; ``stem`` maps
    each JAX stem conv/bn pair (``conv{i}``, ``bn{i}``) to its torch
    names."""
    for i, (conv, bn) in enumerate(stem, start=1):
        sd[f"{conv}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        _bn(sd, bn, p[f"bn{i}"]["bn"], s[f"bn{i}"]["bn"])
    for st, b in _blocks(p):
        src, ss = p[f"layer{st}_block{b}"], s[f"layer{st}_block{b}"]
        dst = f"{pre}layer{st}.{b}"
        for c in (1, 2, 3):
            sd[f"{dst}.conv{c}.weight"] = _conv(src[f"conv{c}"]["kernel"])
            _bn(sd, f"{dst}.bn{c}", src[f"bn{c}"]["bn"], ss[f"bn{c}"]["bn"])
        if "downsample_conv" in src:
            sd[f"{dst}.downsample.0.weight"] = _conv(
                src["downsample_conv"]["kernel"])
            _bn(sd, f"{dst}.downsample.1", src["downsample_bn"]["bn"],
                ss["downsample_bn"]["bn"])


def _backbone_stem(deep_base: bool) -> list:
    n = 3 if deep_base else 1
    return [(f"backbone.conv{i}", f"backbone.bn{i}") for i in range(1, n + 1)]


def _ppm(sd, p, s) -> None:
    i = 0
    while f"bin{i}" in p:
        dst = f"ppm.features.{i}"
        sd[f"{dst}.1.weight"] = _conv(p[f"bin{i}"]["conv"]["kernel"])
        _bn(sd, f"{dst}.2", p[f"bin{i}"]["bn"], s[f"bin{i}"]["bn"])
        i += 1


def _conv_bn(sd, dst: str, p, s) -> None:
    """A JAX ``_ConvBnRelu`` (``conv``, ``bn``) -> the port's
    ``ConvBnRelu``."""
    sd[f"{dst}.conv.weight"] = _conv(p["conv"]["kernel"])
    _bn(sd, f"{dst}.bn", p["bn"], s["bn"])


def _aspp(sd, p, s) -> None:
    for name in p:
        _conv_bn(sd, f"aspp.{name}", p[name], s[name])


def _head(sd, name: str, p, s) -> None:
    """A JAX ``_ClsHead`` -> the reference Sequential ``{name}.{0,1,4}``."""
    sd[f"{name}.0.weight"] = _conv(p["conv"]["conv"]["kernel"])
    _bn(sd, f"{name}.1", p["conv"]["bn"], s["conv"]["bn"])
    _conv_bias(sd, f"{name}.4", p["classifier"])


def _heads(sd, params, stats, names) -> None:
    for name in names:
        _head(sd, name, params[name], stats[name])


def pspnet_state_dict_from_jax(params: Dict, batch_stats: Dict,
                               deep_base: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """``PSPNet`` variables -> the reference ``state_dict`` layout
    (``layer0.{0,1,3,4,6,7}`` of the deep-base stem, or ``layer0.{0,1}`` of
    the 7x7 one, ``layer{1..4}``, ``ppm.features``, ``cls``, ``aux``) that
    ``convert_pspnet`` reads and ``PSPNet(deep_base=...)`` loads with
    ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    stem = [(f"layer0.{3 * i}", f"layer0.{3 * i + 1}")
            for i in range(3 if deep_base else 1)]
    _resnet(sd, params["backbone"], batch_stats["backbone"], stem, "")
    _ppm(sd, params["ppm"], batch_stats["ppm"])
    _heads(sd, params, batch_stats, ("cls", "aux"))
    return sd


def deeplab_state_dict_from_jax(params: Dict, batch_stats: Dict,
                                deep_base: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """``DeepLabV3`` variables -> the ``state_dict`` of the port's
    ``DeepLabV3(deep_base=...)`` (``backbone``, ``aspp``, ``cls``,
    ``aux``)."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"],
            _backbone_stem(deep_base), "backbone.")
    _aspp(sd, params["aspp"], batch_stats["aspp"])
    _heads(sd, params, batch_stats, ("cls", "aux"))
    return sd


def ddcat_state_dict_from_jax(params: Dict, batch_stats: Dict
                              ) -> Dict[str, torch.Tensor]:
    """``PSPNetDDCAT`` or ``DeepLabV3DDCAT`` variables (7x7 stem; ``ppm`` or
    ``aspp``) -> the port's ``state_dict`` (``backbone``, ``ppm`` or
    ``aspp``, ``cls1``, ``cls2``, ``mask1``, ``aux_cls1``)."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"],
            _backbone_stem(False), "backbone.")
    if "ppm" in params:
        _ppm(sd, params["ppm"], batch_stats["ppm"])
    else:
        _aspp(sd, params["aspp"], batch_stats["aspp"])
    _heads(sd, params, batch_stats, ("cls1", "cls2", "mask1", "aux_cls1"))
    return sd


def _vit_block(sd, dst: str, p) -> None:
    _ln(sd, f"{dst}.norm1", p["norm1"])
    _ln(sd, f"{dst}.norm2", p["norm2"])
    for sub, names in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
        for name in names:
            node = p[sub][name]
            sd[f"{dst}.{sub}.{name}.weight"] = _lin(node["kernel"])
            sd[f"{dst}.{sub}.{name}.bias"] = _t(node["bias"])


def segmenter_state_dict_from_jax(params: Dict, n_layers: int = 12,
                                  distilled: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """``SegMenter`` params (mask-transformer decoder) -> the reference
    ``state_dict`` layout (``encoder.patch_embed.proj``,
    ``encoder.blocks.{i}``, ``decoder.proj_dec``, ``decoder.cls_emb``, ...)
    that ``convert_segmenter`` reads and the port's ``SegMenter`` loads with
    ``strict=True``. ``n_layers`` counts the encoder's blocks; the
    decoder's come from the tree."""
    sd: Dict[str, torch.Tensor] = {}
    e, d = params["encoder"], params["decoder"]
    _conv_bias(sd, "encoder.patch_embed.proj", e["patch_embed"])
    sd["encoder.cls_token"] = _t(e["cls_token"])
    if distilled:
        sd["encoder.dist_token"] = _t(e["dist_token"])
    sd["encoder.pos_embed"] = _t(e["pos_embed"])
    for i in range(n_layers):
        _vit_block(sd, f"encoder.blocks.{i}", e[f"block{i}"])
    _ln(sd, "encoder.norm", e["norm"])
    sd["decoder.proj_dec.weight"] = _lin(d["proj_dec"]["kernel"])
    sd["decoder.proj_dec.bias"] = _t(d["proj_dec"]["bias"])
    for name in ("cls_emb", "proj_patch", "proj_classes"):
        sd[f"decoder.{name}"] = _t(d[name])
    i = 0
    while f"block{i}" in d:
        _vit_block(sd, f"decoder.blocks.{i}", d[f"block{i}"])
        i += 1
    _ln(sd, "decoder.decoder_norm", d["decoder_norm"])
    _ln(sd, "decoder.mask_norm", d["mask_norm"])
    return sd


def state_dict_from_jax(model_name: str, backbone: str, params: Dict,
                        batch_stats: Dict, pspnet_clean: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``build_model(model_name, backbone,
    ..., pspnet_clean)`` from JAX variables, by model name."""
    if model_name == "UperNetForSemanticSegmentation":
        return upernet_state_dict_from_jax(params, batch_stats,
                                           backbone.split("-")[1])
    if model_name == "SegMenter":
        from robseg_torch.models import SEGMENTER_VARIANTS
        v = SEGMENTER_VARIANTS[backbone]
        return segmenter_state_dict_from_jax(
            params, v["n_layers"], v.get("distilled", False))
    if model_name == "PSPNet":
        return pspnet_state_dict_from_jax(params, batch_stats, pspnet_clean)
    if model_name == "DeepLabV3":
        return deeplab_state_dict_from_jax(params, batch_stats)
    if model_name in ("PSPNet_DDCAT", "DeepLabV3_DDCAT"):
        return ddcat_state_dict_from_jax(params, batch_stats)
    raise ValueError(f"Unknown model {model_name!r}")


def load_params_npz(path: str) -> Dict:
    """A JAX ``save_params_npz`` file -> nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


def npz_state_dict(path: str, model_name: str, backbone: str = "",
                   pspnet_clean: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a JAX trainer's ``.npz`` (and its
    ``.stats.npz``, the BatchNorm statistics, where the model has any)."""
    params = load_params_npz(path)
    stats_path = str(path)[:-len(".npz")] + ".stats.npz"
    stats = load_params_npz(stats_path) if os.path.exists(stats_path) else {}
    return state_dict_from_jax(model_name, backbone, params, stats,
                               pspnet_clean=pspnet_clean)
