"""The measurement accounting of chip_smoke.py, on the CPU.

The script itself runs only on the card; what it computes from shapes and
names does not: the bound of a kernel's work (the larger of its bytes over
the memory rate and its operations over the peak rate of their type), the
sum of per-stage bounds, the MLP tail's library products, and how profiled
kernel names are shortened and grouped into the block kernels' parts and
the paths' kinds of work. The names below are as torch.profiler reported
them on the H100.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

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


def test_float32_products_are_bound_at_three_tf32_passes(smoke):
    # the float32-accurate MLP products run as three TF32 passes on the
    # tensor cores (495 TFLOP/s dense), not at the 67 TFLOP/s of the FP32
    # pipes
    assert smoke.PEAK_FLOPS["tf32x3"] == pytest.approx(494.7e12 / 3)
    ms, by = smoke.bound(3.35e8, {"tf32x3": 494.7e12 / 3})   # 0.1 ms bytes
    assert ms == pytest.approx(1000.0) and by == "operations"
    # one stage of the 512^2 model at batch 16 (C = 96): 16 n C^2 products
    n, c = 16 * 128 * 128, 96
    ms, by = smoke.bound(8 * n * c + 16 * n * c + 32 * c * c,
                         {"tf32x3": 16 * n * c * c})
    assert ms == pytest.approx(0.2344, abs=1e-4) and by == "operations"


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("save_h", [False, True])
def test_mlp_products_are_the_tails_matmuls(smoke, save_h, bf16):
    """The library yardstick: one torch.matmul a product at the mode's
    operand precision, two forward, two (h read) or three (h recomputed)
    for the input gradient."""
    from robseg_torch.kernels import convnext_mlp as cm
    rng = np.random.default_rng(0)
    c = 32
    p = smoke.block_params(rng, c, "cpu")[2:]
    ls, lb, w1, b1, w2, b2, g = p
    y = torch.randn(1, 3, 5, c)
    dy = torch.randn(y.shape)
    _, h = cm.convnext_mlp_fwd_plain(y, *p, save_h=True)
    fwd, dx = smoke.mlp_products(y, dy, p, h if save_h else None, bf16,
                                 save_h)
    assert len(fwd) == 2 and len(dx) == (2 if save_h else 3)
    dtype = torch.bfloat16 if bf16 else torch.float32
    outs = [f() for f in fwd + dx]
    assert all(o.dtype == dtype for o in outs)
    assert [tuple(o.shape) for o in outs] == (
        [(15, 4 * c), (15, c), (15, 4 * c), (15, c)]
        + ([] if save_h else [(15, 4 * c)]))
    _, _, u = cm._layer_norm(y.reshape(-1, c), ls, lb)
    want = torch.nn.functional.linear(u, w1)
    tol = dict(atol=0.1, rtol=0.05) if bf16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[0].float(), want, **tol)
    torch.testing.assert_close(outs[2].float(), (g * dy).reshape(-1, c) @ w2,
                               **tol)


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
    ("void (anonymous namespace)::mlp_tf32_kernel<96, 0, 1>((anonymous "
     "namespace)::Tf32Params)", "mlp_tf32_kernel<96, 0, 1>"),
    ("void (anonymous namespace)::ln_rows_kernel<192, float>(float const*, "
     "float const*, float const*, float*, float*, float*, float const*, "
     "float const*, float*, long)", "ln_rows_kernel<192, float>"),
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
    ("void (anonymous namespace)::mlp_fused_kernel<96, true, false>(x)",
     "block mlp"),
    ("(anonymous namespace)::dwcorr_kernel(x)", "block depthwise"),
    ("void (anonymous namespace)::mlp_tf32_kernel<128, 1, 2>(x)",
     "MLP tail"),
    ("void (anonymous namespace)::ln_rows_kernel<96, float>(x)", "MLP tail"),
    ("void (anonymous namespace)::fpn_gemm_kernel((anonymous namespace)::"
     "Params)", "FPN concat-conv"),
])
def test_kernel_kind(smoke, name, kind):
    assert smoke.kernel_kind(name) == kind


# on the fused-variant path no block kernel runs: the MLP kernels,
# packing and LayerNorm backward shared with the block are the tail's
@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::mlp_fused_kernel<192, true, true>(x)",
     "MLP tail"),
    ("void (anonymous namespace)::mlp_gemm_kernel<4>(x)", "MLP tail"),
    ("(anonymous namespace)::ln_bwd_kernel(float*, long, int)", "MLP tail"),
    ("(anonymous namespace)::pack_kernel((anonymous namespace)::PackParams)",
     "MLP tail"),
    ("void (anonymous namespace)::mlp_tf32_kernel<96, 1, 3>(x)", "MLP tail"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>(x)",
     "elementwise, norms, resize, loss"),
    ("cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(x)",
     "convolution (cuDNN)"),
    ("void (anonymous namespace)::fpn_gemm_kernel(x)", "FPN concat-conv"),
])
def test_kernel_kind_on_the_fused_variant_path(smoke, name, kind):
    assert smoke.kernel_kind(name, tail=True) == kind


def test_bf16_forms_round_the_float32_form_once(smoke):
    """The bf16 check's reference: the float32 form on the upcast operands
    (lists too), its result (or each of a tuple) rounded once to bf16."""
    seen = []

    def f32_form(xs, w):
        seen.append([t.dtype for t in xs] + [w.dtype])
        return xs[0] * w, xs[1] * w

    x = [torch.tensor([1.0, 1 + 2 ** -7]).to(torch.bfloat16)] * 2
    w = torch.tensor(3.0).to(torch.bfloat16)
    got, want = smoke.bf16_forms(lambda xs, w: "kernel", f32_form, x, w)
    assert got == "kernel"
    assert seen == [[torch.float32] * 3]
    # 3 * (1 + 2^-7) = 3 + 3 * 2^-7 lies halfway between two bf16 values
    # (steps of 2^-6 there) and rounds to the even one, 3 + 2^-5
    assert all(t.dtype == torch.bfloat16 for t in want)
    assert float(want[0][1]) == 3 + 2 ** -5


def test_n_differ_counts_bits(smoke):
    a = torch.tensor([1.0, -0.0, 2.0]).to(torch.bfloat16)
    b = torch.tensor([1.0, 0.0, 2 + 2 ** -6]).to(torch.bfloat16)
    assert smoke.n_differ(a, a.clone()) == 0
    # -0 and +0 differ in their bits; 2 and 2 + 2^-6 by one bf16 step
    assert smoke.n_differ(a, b) == 2
    assert smoke.n_differ((a, a), (a, b)) == 2


def test_strict_float32_scopes_tf32_off(smoke):
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with smoke.strict_float32():
            assert not any(f.allow_tf32 for f in flags)
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::dwconv_ln_kernel<(anonymous namespace)::"
     "DwTile<8, 16, 8, 2>, __nv_bfloat16>(x)", "block depthwise"),
    ("void (anonymous namespace)::dwcorr_kernel<__nv_bfloat16>(x)",
     "block depthwise"),
    ("void (anonymous namespace)::mlp_fused_kernel<96, false, false, "
     "__nv_bfloat16>(x)", "block mlp"),
    ("void (anonymous namespace)::mlp_gemm_kernel<5>(x)", "block mlp"),
    ("void (anonymous namespace)::fpn_gemm_kernel<__nv_bfloat16>(x)",
     "FPN concat-conv"),
    ("void (anonymous namespace)::relu_grad_kernel<__nv_bfloat16>(x)",
     "FPN concat-conv"),
])
def test_kernel_kind_of_the_bf16_forms(smoke, name, kind):
    assert smoke.kernel_kind(name) == kind


class _Event:
    def __init__(self, key, us, count):
        self.key, self.self_device_time_total, self.count = key, us, count


def _fake_profiler(monkeypatch, windows):
    """torch.profiler.profile handing back ``windows`` in turn (each a list
    of events), and a no-op torch.cuda.synchronize."""
    import torch.profiler
    seen = iter(windows)

    class Profile:
        def __init__(self, **_):
            self.events = next(seen)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def test_profiled_takes_an_empty_window_again(smoke, monkeypatch):
    """CUPTI now and then hands back a window with no device time: it is
    taken again, and the next window's rows are per call."""
    _fake_profiler(monkeypatch, [[_Event("k", 0.0, 3)],
                                 [_Event("k", 600.0, 3),
                                  _Event("host", 0.0, 3)]])
    calls = []
    rows, wall = smoke.profiled(lambda: calls.append(1), reps=3)
    assert rows == [("k", pytest.approx(0.2), 1.0)]
    assert len(calls) == 6 and wall >= 0.0


def test_split_not_measured_when_every_window_is_empty(smoke, monkeypatch,
                                                       capsys):
    """No device time in any window: the split says so and the run goes on
    (a kernel's time comes from CUDA events, not from the profiler)."""
    _fake_profiler(monkeypatch, [[] for _ in range(3)])
    assert smoke.print_split("block x fwd", lambda: None) == {}
    assert "block x fwd split: not measured" in capsys.readouterr().out
