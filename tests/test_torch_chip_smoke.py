"""The measurement accounting of chip_smoke.py, on the CPU.

The script itself runs only on the card; what it computes from shapes and
names does not: the bound of a kernel's work (the larger of its bytes over
the memory rate and its operations over the peak rate of their type), the
sum of per-stage bounds, and how profiled kernel names are shortened and
grouped into the block kernels' parts and the main path's kinds of work.
The names below are as torch.profiler reported them on the H100.
"""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nbytes,flops,want", [
    (3.35e9, {"bf16": 1e9}, (1.0, "bytes")),         # 1 ms of bytes
    (1e6, {"bf16": 989e12}, (1000.0, "operations")),
    (1e6, {"bf16": 1e9, "f32": 67e12}, (1000.0, "operations")),
])
def test_bound_takes_the_larger_time(smoke, nbytes, flops, want):
    ms, by = smoke.bound(nbytes, flops)
    assert ms == pytest.approx(want[0]) and by == want[1]


def test_add_bound_sums_stages_and_names_the_larger_part(smoke):
    row = {}
    smoke.add_bound(row, 3.35e9, {"bf16": 0.0})     # 1 ms of bytes
    smoke.add_bound(row, 0.0, {"bf16": 989e9})      # 1 ms of operations
    smoke.add_bound(row, 0.0, {"bf16": 989e9})
    assert row["bound_ms"] == pytest.approx(3.0)
    assert row["bound_by"] == "operations"


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::mlp_fused_kernel<96, false>((anonymous "
     "namespace)::FusedParams)", "mlp_fused_kernel<96, false>"),
    ("(anonymous namespace)::dwcorr_kernel(float const*, float const*, "
     "float const*, float*, int, int, int)", "dwcorr_kernel"),
    ("void (anonymous namespace)::dwconv_ln_kernel<(anonymous namespace)::"
     "DwTile<8, 16, 8, 2> >(float const*, int)",
     "dwconv_ln_kernel<DwTile<8, 16, 8, 2> >"),
])
def test_short_name_drops_arguments_and_namespaces(smoke, name, want):
    assert smoke.short_name(name) == want


@pytest.mark.parametrize("name,part", [
    ("void (anonymous namespace)::mlp_fused_kernel<192, true>(x)", "mlp"),
    ("void (anonymous namespace)::mlp_gemm_kernel<2>(x)", "mlp"),
    ("void (anonymous namespace)::dwconv_ln_kernel<(anonymous namespace)::"
     "DwTile<4, 4, 2, 1> >(x)", "depthwise"),
    ("(anonymous namespace)::dwcorr_kernel(x)", "depthwise"),
    ("(anonymous namespace)::ln_bwd_kernel(float*, long, int)", "ln_bwd"),
    ("(anonymous namespace)::pack_kernel((anonymous namespace)::PackParams)",
     "packing"),
])
def test_block_part(smoke, name, part):
    assert smoke.block_part(name) == part


@pytest.mark.parametrize("name,kind", [
    ("cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(x)",
     "convolution (cuDNN)"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw(x)",
     "convolution (cuDNN)"),
    ("cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(x)",
     "elementwise, norms, resize, loss"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>(x)",
     "elementwise, norms, resize, loss"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32(x)",
     "matmul (cuBLAS)"),
    ("void (anonymous namespace)::mlp_fused_kernel<96, true>(x)",
     "block mlp"),
    ("(anonymous namespace)::dwcorr_kernel(x)", "block depthwise"),
])
def test_kernel_kind(smoke, name, kind):
    assert smoke.kernel_kind(name) == kind
