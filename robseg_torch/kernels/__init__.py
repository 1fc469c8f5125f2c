"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
main path's four, and the fused-head and MLP-tail kernels of the model's
other fused settings. The library is built from ``robseg_torch/csrc`` at the
first launch (``_build.py``)."""

from robseg_torch.kernels.apgd_step import (  # noqa: F401
    apgd_linf_step, apgd_linf_step_cuda, apgd_linf_step_plain)
from robseg_torch.kernels.confusion import (  # noqa: F401
    confusion_hist, confusion_matrix_cuda, confusion_matrix_plain)
from robseg_torch.kernels.convnext_block import (  # noqa: F401
    ConvNeXtBlockFn, convnext_block_dx_bf16_cuda, convnext_block_dx_cuda,
    convnext_block_dx_plain, convnext_block_fwd_bf16_cuda,
    convnext_block_fwd_cuda, convnext_block_plain)
from robseg_torch.kernels.convnext_mlp import (  # noqa: F401
    ConvNeXtMlpFn, convnext_mlp_dx_cuda, convnext_mlp_dx_plain,
    convnext_mlp_fwd_cuda, convnext_mlp_fwd_plain, convnext_mlp_plain)
from robseg_torch.kernels.fpn_conv import (  # noqa: F401
    FpnConcatConvFn, fpn_concat_conv, fpn_concat_conv_dx_bf16_cuda,
    fpn_concat_conv_dx_cuda, fpn_concat_conv_dx_plain,
    fpn_concat_conv_fwd_bf16_cuda, fpn_concat_conv_fwd_cuda,
    fpn_concat_conv_fwd_plain, fpn_concat_conv_plain)

# each CUDA wrapper counts its own launches (a plain int attribute); the
# bf16 I/O forms of the block and FPN kernels count apart from their
# float32 forms
CUDA_WRAPPERS = {
    "convnext_block_fwd": convnext_block_fwd_cuda,
    "convnext_block_dx": convnext_block_dx_cuda,
    "apgd_linf_step": apgd_linf_step_cuda,
    "confusion_matrix": confusion_matrix_cuda,
    "fpn_concat_conv_fwd": fpn_concat_conv_fwd_cuda,
    "fpn_concat_conv_dx": fpn_concat_conv_dx_cuda,
    "convnext_mlp_fwd": convnext_mlp_fwd_cuda,
    "convnext_mlp_dx": convnext_mlp_dx_cuda,
    "convnext_block_fwd_bf16": convnext_block_fwd_bf16_cuda,
    "convnext_block_dx_bf16": convnext_block_dx_bf16_cuda,
    "fpn_concat_conv_fwd_bf16": fpn_concat_conv_fwd_bf16_cuda,
    "fpn_concat_conv_dx_bf16": fpn_concat_conv_dx_bf16_cuda,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in CUDA_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in CUDA_WRAPPERS.values():
        fn.launches = 0
