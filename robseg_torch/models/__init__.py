"""Model zoo and the ``logits_fn`` holder.

Port of ``robseg_tpu/models/__init__.py`` for the UperNet-ConvNeXt family;
``build_model`` names the later port slice for every other model.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from robseg_torch.models.convnext import (  # noqa: F401
    CONVNEXT_SETTINGS, ConvNeXt)
from robseg_torch.models.upernet import (  # noqa: F401
    UperNetFCNHead, UperNetForSemanticSegmentation, UperNetHead)

_LATER = ("SegMenter", "PSPNet", "PSPNet_DDCAT", "DeepLabV3",
          "DeepLabV3_DDCAT")


def build_model(model_name: str, backbone: str, n_cls: int) -> nn.Module:
    """The module for a (MODEL.NAME, BACKBONE, N_CLS) triple, in eval mode.

    UperNet always runs the split bottleneck and the block kernel, the
    configuration ``robseg_tpu``'s ``build_model(fused=True)`` selects; the
    other fused settings are the module's arguments
    (``robseg_torch.bench_fused`` builds them).
    """
    if model_name == "UperNetForSemanticSegmentation":
        variant = backbone.split("-")[1]
        return UperNetForSemanticSegmentation(
            variant, n_cls, fused_mlp=True, fused_mlp_mode="block",
            fused_head="split").eval()
    if model_name in _LATER:
        raise NotImplementedError(
            f"{model_name} is not ported yet: the Segmenter and PSPNet/"
            "DeepLab families are a later slice of the port (ROADMAP.md)")
    raise ValueError(f"Unknown model {model_name!r}")


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
    is."""
    module: nn.Module
    precision: str = "default"
    PRECISIONS = ("default", "bf16")

    def __post_init__(self):
        if self.precision not in self.PRECISIONS:
            raise ValueError(f"precision {self.precision!r}: one of "
                             f"{self.PRECISIONS}")
        self.module.eval().requires_grad_(False)
        if self.precision == "bf16":
            self.module.to(torch.bfloat16)

    def logits_fn(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":
            return self.module(x.to(torch.bfloat16)).float()
        return self.module(x)
