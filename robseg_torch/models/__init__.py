"""Model zoo and the ``logits_fn`` holder.

Port of ``robseg_tpu/models/__init__.py``: ``build_model`` builds each of
the six model names the JAX package builds (UperNet-ConvNeXt, Segmenter-ViT,
PSPNet, PSPNet-DDCAT, DeepLabV3, DeepLabV3-DDCAT), in eval mode, and
``ModelBundle`` holds a module with its ``logits_fn``. ``ModelBundle``
freezes the module it is given, so the trainer never hands it the module
it trains.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from robseg_torch.models.convnext import (  # noqa: F401
    CONVNEXT_SETTINGS, ConvNeXt)
from robseg_torch.models.pspnet import (  # noqa: F401
    ASPP, PPM, DeepLabV3, DeepLabV3DDCAT, PSPNet, PSPNetDDCAT)
from robseg_torch.models.resnet import Bottleneck, ResNetStages  # noqa: F401
from robseg_torch.models.segmenter import (  # noqa: F401
    DecoderLinear, MaskTransformer, SegMenter)
from robseg_torch.models.upernet import (  # noqa: F401
    UperNetFCNHead, UperNetForSemanticSegmentation, UperNetHead)
from robseg_torch.models.vit import VisionTransformer  # noqa: F401
from robseg_torch.models.wrappers import (  # noqa: F401
    mask_class, mask_logits, normalize_input, normalize_model)

# The Segmenter zoo (copy of robseg_tpu/models/__init__.py:31-58;
# tests/test_torch_import.py checks that the two agree): image size from
# the dataset crop, a 2-layer mask transformer.
SEGMENTER_VARIANTS = {
    "vit_tiny_patch16_384": dict(d_model=192, n_heads=3, n_layers=12),
    "vit_small_patch16_224": dict(d_model=384, n_heads=6, n_layers=12),
    "vit_small_patch16_384": dict(d_model=384, n_heads=6, n_layers=12),
    "vit_small_patch32_384": dict(d_model=384, n_heads=6, n_layers=12,
                                  patch_size=32),
    "vit_base_patch16_384": dict(d_model=768, n_heads=12, n_layers=12),
    "vit_base_patch8_384": dict(d_model=768, n_heads=12, n_layers=12,
                                patch_size=8),
    "vit_base_patch32_384": dict(d_model=768, n_heads=12, n_layers=12,
                                 patch_size=32),
    "vit_large_patch32_384": dict(d_model=1024, n_heads=16, n_layers=24,
                                  patch_size=32),
    "vit_base_patch16_SAM": dict(d_model=768, n_heads=12, n_layers=12),
    "vit_large_patch16_384": dict(d_model=1024, n_heads=16, n_layers=24),
    "deit_tiny_distilled_patch16_224": dict(d_model=192, n_heads=3,
                                            n_layers=12, distilled=True),
    "deit_small_distilled_patch16_224": dict(d_model=384, n_heads=6,
                                             n_layers=12, distilled=True),
    "deit_base_distilled_patch16_224": dict(d_model=768, n_heads=12,
                                            n_layers=12, distilled=True),
    "deit_base_distilled_patch16_384": dict(d_model=768, n_heads=12,
                                            n_layers=12, distilled=True),
}


def create_segmenter(backbone: str, n_cls: int, image_size=(512, 512)
                     ) -> SegMenter:
    """A zoo Segmenter at ``image_size`` (the native position-embedding
    grid), with a 2-layer mask-transformer decoder."""
    v = dict(SEGMENTER_VARIANTS[backbone])
    patch_size = v.pop("patch_size", 16)
    return SegMenter(n_cls=n_cls, image_size=tuple(image_size),
                     patch_size=patch_size, drop_path_rate=0.1,
                     decoder_n_layers=2, **v)


def build_model(model_name: str, backbone: str, n_cls: int,
                image_size=(512, 512), pspnet_clean: bool = True,
                fused: Optional[bool] = None) -> nn.Module:
    """The module for a (MODEL.NAME, BACKBONE, N_CLS) triple, in eval mode.

    UperNet runs the split bottleneck and the block kernel, the
    configuration ``robseg_tpu``'s ``build_model(fused=True)`` selects,
    unless ``fused=False``: then it is the plain module
    (``fused_mlp=False``, ``fused_head=False``, JAX's ``fused=False``), the
    one that trains. ``fused=None`` is the default of each name (fused for
    UperNet); ``fused=True`` on another name raises, as JAX's does. The
    other fused settings are the module's arguments
    (``robseg_torch.bench_fused`` builds them). ``image_size`` is the
    Segmenter's native grid (the dataset crop); ``pspnet_clean`` picks
    PSPNet's deep-base 3-conv stem (True) or the 7x7 stem of the robust
    checkpoints.
    """
    if fused and model_name != "UperNetForSemanticSegmentation":
        raise ValueError(
            f"fused=True is only supported for UperNet (ConvNeXt backbone); "
            f"got MODEL.NAME={model_name!r}")
    if model_name == "UperNetForSemanticSegmentation":
        variant = backbone.split("-")[1]
        plain = fused is False
        module = UperNetForSemanticSegmentation(
            variant, n_cls, fused_mlp=not plain, fused_mlp_mode="block",
            fused_head=False if plain else "split")
    elif model_name == "SegMenter":
        module = create_segmenter(backbone, n_cls, image_size)
    elif model_name == "PSPNet":
        module = PSPNet(classes=n_cls, deep_base=pspnet_clean)
    elif model_name == "PSPNet_DDCAT":
        module = PSPNetDDCAT(classes=n_cls)
    elif model_name == "DeepLabV3":
        module = DeepLabV3(classes=n_cls)
    elif model_name == "DeepLabV3_DDCAT":
        module = DeepLabV3DDCAT(classes=n_cls)
    else:
        raise ValueError(f"Unknown model {model_name!r}")
    return module.eval()


@dataclasses.dataclass
class ModelBundle:
    """A module in eval mode on its device, exposing the
    ``logits_fn(x (B,3,H,W) in [0,1]) -> logits (B,K,H,W)`` the attacks
    and the evaluation consume (counterpart of robseg_tpu's ModelBundle).
    The weights are attack-time constants: they are frozen, so autograd
    tracks the input gradient only.

    ``precision="bf16"`` is ``tools/infer.py --precision bf16``: the
    module's floating parameters and buffers (the BatchNorm statistics
    too) become bfloat16, and ``logits_fn`` runs the module on the input
    cast to bfloat16 and returns float32 logits, so the attack's iterate,
    loss and step stay float32. ``"default"`` leaves the module as it
    is. ``normalize`` applies the ImageNet mean/std normalisation to the
    input first (``models/wrappers.py::normalize_input``), as the JAX
    bundle's field does."""
    module: nn.Module
    precision: str = "default"
    normalize: bool = False
    PRECISIONS = ("default", "bf16")

    def __post_init__(self):
        if self.precision not in self.PRECISIONS:
            raise ValueError(f"precision {self.precision!r}: one of "
                             f"{self.PRECISIONS}")
        self.module.eval().requires_grad_(False)
        if self.precision == "bf16":
            self.module.to(torch.bfloat16)

    def logits_fn(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            x = normalize_input(x)
        if self.precision == "bf16":
            return self.module(x.to(torch.bfloat16)).float()
        return self.module(x)
