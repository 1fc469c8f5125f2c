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
import re
from pathlib import Path

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
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "matmul (cuBLAS)"),
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


def test_depthwise_bytes_count_each_tensor_once(smoke):
    """The depthwise passes' bytes (phases 2 and 2b): 12 an element for the
    backward's bf16 dwconv_ln (x, dy, u, gms 2 each; xhat 4) and 8 for its
    dwcorr (dyconv 4; dy, dx 2), 16 and 12 in float32, 6 / 4 for the
    forward's; beside them 1/sigma a token and the taps and vectors."""
    n, c = 16 * 128 * 128, 96
    taps = 54 * c * 4
    assert smoke.depthwise_bytes(n, c, 2, True) == {
        "dwconv_ln_kernel": 12 * n * c + 4 * n + taps,
        "dwcorr_kernel": 8 * n * c + taps}
    assert smoke.depthwise_bytes(n, c, 4, True) == {
        "dwconv_ln_kernel": 16 * n * c + 4 * n + taps,
        "dwcorr_kernel": 12 * n * c + taps}
    assert smoke.depthwise_bytes(n, c, 4, False) == {
        "dwconv_ln_kernel": 6 * n * c + taps}
    # the four batch-16 stages' bf16 dx: 0.28 ms at 3.35 TB/s
    total = sum(sum(smoke.depthwise_bytes(16 * hw * hw, c, 2, True).values())
                for hw, c in ((128, 96), (64, 192), (32, 384), (16, 768)))
    assert total / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.2823,
                                                                abs=1e-4)


def test_split_prints_parts_against_their_bytes_bounds(smoke, monkeypatch,
                                                       capsys):
    """Kernels named in part_bytes are printed beside their bytes bound and
    share, and returned under "bounds" as [ms, bound_ms]."""
    _fake_profiler(monkeypatch, [[
        _Event("void dwconv_ln_kernel<DwTile<8, 8, 4, 2>, float, true>"
               "(DwParams)", 3 * 200.0, 3),
        _Event("void mlp_fused_kernel<96, true, false, float>(int)",
               3 * 350.0, 3)]])
    nbytes = 0.1e-3 * smoke.HBM_BYTES_PER_S  # 0.1 ms of bytes
    parts = smoke.print_split("block x dx", lambda: None,
                              {"dwconv_ln_kernel": nbytes,
                               "dwcorr_kernel": nbytes})
    assert parts["depthwise"] == pytest.approx(0.2)
    assert parts["mlp"] == pytest.approx(0.35)
    assert parts["bounds"]["dwconv_ln_kernel"] == [pytest.approx(0.2),
                                                   pytest.approx(0.1)]
    assert parts["bounds"]["dwcorr_kernel"][0] == 0.0
    out = capsys.readouterr().out
    assert ("block x dx parts against their bytes bounds: dwconv_ln_kernel "
            "0.2000 ms, bound 0.1000 ms, share 50.0%") in out
    assert "dwcorr_kernel 0.0000" not in out


def test_block_fwd_bounds_and_gelu_floor(smoke):
    """The forward's kernels each against their own work: at stage 0 of
    batch 16 (bf16) the fused MLP is bound by its bytes (u, x and out: 6 n
    C, 0.045 ms; its 16 n C^2 products 0.039 ms), dwconv_ln by its 49 FMAs
    an element, and the n 4C GELUs at 25 float32 instructions take 0.075
    ms of the CUDA cores; at 16^2 the two GEMMs split the products, the
    bf16 hidden layer written by the first and read by the second."""
    n, c = 16 * 128 * 128, 96
    b = smoke.block_fwd_bounds(n, c, 2, 2)
    assert set(b) == {"pack_kernel", "dwconv_ln_kernel", "mlp_fused_kernel"}
    assert b["mlp_fused_kernel"] == (pytest.approx(0.0451, abs=1e-4),
                                     "bytes")
    assert b["dwconv_ln_kernel"] == (pytest.approx(0.0368, abs=1e-4),
                                     "operations")
    assert smoke.gelu_floor_ms(n, c) == pytest.approx(0.0751, abs=1e-4)
    n, c = 16 * 16 * 16, 768
    b = smoke.block_fwd_bounds(n, c, 2, 2)
    assert set(b) == {"pack_kernel", "dwconv_ln_kernel", "mlp_gemm_kernel<0",
                      "mlp_gemm_kernel<5"}
    hid = 2 * n * 4 * c / smoke.HBM_BYTES_PER_S * 1e3
    assert b["mlp_gemm_kernel<0"][0] == pytest.approx(
        max(8 * n * c * c / 989e12 * 1e3,
            hid + (2 * n * c + 8 * c * c) / smoke.HBM_BYTES_PER_S * 1e3))
    assert "mlp_gemm_kernel<1" in smoke.block_fwd_bounds(n, c, 4, 4)


def test_fwd_parts_print_each_kernel_beside_its_bound(smoke, capsys):
    split = [("void mlp_fused_kernel<96, false, false, __nv_bfloat16>"
              "(FusedParams)", 0.2, 1.0),
             ("void dwconv_ln_kernel<DwTile<8, 8, 4, 2>, __nv_bfloat16, "
              "false>(DwParams)", 0.1, 1.0),
             ("void pack_kernel(PackParams)", 0.004, 1.0)]
    parts = smoke.print_fwd_parts("block x fwd", split, 16 * 128 * 128, 96,
                                  2, 2, 0.4)
    assert parts["mlp_fused_kernel<96, false, false, __nv_bfloat16>"] == [
        0.2, pytest.approx(0.0451, abs=1e-4)]
    out = capsys.readouterr().out
    assert "GELU floor 0.0751 ms: 100.7 M exact GELUs" in out
    assert "device sum 0.3040 ms, call 0.4000 ms" in out
    assert smoke.print_fwd_parts("y", [], 1, 96, 2, 2, 1.0) == {}


@pytest.mark.parametrize("key,shapes,kind", [
    ("aten::bmm", [[96, 1025, 64], [96, 64, 1025]], "attention matmuls"),
    ("aten::bmm", [[96, 1025, 1025], [96, 1025, 64]], "attention matmuls"),
    ("aten::bmm", [[2416, 512, 32], [2416, 32, 32]],
     "other matmuls (linear, resize)"),
    ("aten::mm", [[16400, 384], [384, 1152]],
     "other matmuls (linear, resize)"),
    ("aten::addmm", [[1152], [16400, 384], [384, 1152]],
     "other matmuls (linear, resize)"),
    ("aten::_softmax", [[16, 6, 1025, 1025], [], []], "softmax"),
    ("aten::_softmax_backward_data", [[1], [1], [], []], "softmax"),
    ("aten::cudnn_convolution", [[16, 3, 512, 512]], "convolution (cuDNN)"),
    ("aten::convolution_backward", [[1]], "convolution (cuDNN)"),
    ("aten::_log_softmax", [[16, 151, 512, 512]], "elementwise, norms, loss"),
    ("aten::native_layer_norm", [[16, 1025, 384]],
     "elementwise, norms, loss"),
    ("aten::bmm", [], "other matmuls (linear, resize)"),
])
def test_op_kind_splits_attention_from_other_matmuls(smoke, key, shapes,
                                                     kind):
    """The families' profile: an ``aten::bmm`` of batch 16 x 6 heads is an
    attention product; the loss's log-softmax is not the attention's."""
    assert smoke.op_kind(key, shapes, {96}) == kind


@pytest.mark.parametrize("k", [151, 847])
@pytest.mark.parametrize("blocky", [False, True])
def test_label_maps(smoke, blocky, k):
    """The confusion phase's labels: classes in [0, K) or -1 in both maps
    at once, pred = target on about half, about 5% ignored; blocky maps
    constant on 32 x 32 regions."""
    pred, tgt = smoke.label_maps((2, 96, 80), k, blocky, "cpu", 0)
    assert pred.dtype == tgt.dtype == torch.int64
    assert torch.equal(pred == -1, tgt == -1)
    assert int(tgt.min()) == -1 and int(tgt.max()) < k
    assert int(pred.max()) < k
    assert 0.3 < float((pred == tgt).float().mean()) < 0.7
    assert 0.0 < float((tgt == -1).float().mean()) < 0.2
    regions = tgt.reshape(2, 3, 32, 80)[:, :, :, :64].reshape(
        2, 3, 32, 2, 32).permute(0, 1, 3, 2, 4).reshape(12, -1)
    same = (regions == regions[:, :1]).all(1)
    assert bool(same.all()) == blocky


def test_confusion_cases(smoke):
    """The confusion phase covers both forms of the kernel: K = 21 and 151
    (shared), 239 (the global form's first K) up to ADE20K-full's 847,
    whose 16 per-image outputs on an H100 (132 SMs, 50 MiB of L2) are
    counted half at once, and 673, whose are not; the first design, one
    K x K histogram in shared memory, runs only where K <= 238. Each form
    names the kernel the phase looks for in the profiler's list."""
    from robseg_torch.kernels import confusion as cf
    h100 = (132, 50 << 20)
    ks = [k for k, _ in smoke.CONFUSION_CASES]
    assert ks[:2] == [smoke.N_CLS, smoke.N_ADE] and {239, 847} <= set(ks)
    assert len(set(ks)) == len(ks)
    assert set(smoke.CONFUSION_KERNEL) == set(cf.FORMS)
    for k, with_v1 in smoke.CONFUSION_CASES:
        assert with_v1 == (k <= cf.SHARED_MAX_CLASSES)
        for rows in (1, 16):
            assert cf.plan(k, rows, 16 * 512 * 512 // rows, *h100)[
                "form"] == ("shared" if with_v1 else "global")
    per_image = {k: cf.plan(k, 16, 512 * 512, *h100)["grid"][0] for k in ks}
    assert per_image[847] == 33 and per_image[673] == 16
    src = (Path(cf.__file__).parents[1] / "csrc" / "confusion.cu").read_text()
    for kernel in smoke.CONFUSION_KERNEL.values():
        assert re.search(rf"\b{kernel}\(", src), kernel


def test_fixture_ade_is_an_ade20k_val_tree(smoke, tmp_path):
    """The SEA CLI's ADE20K fixture reads as the port's ADE20K val set:
    8 images at the 512^2 crop, labels 0..150."""
    from robseg_torch.data import get_segmentation_dataset
    root = smoke.fixture_ade(str(tmp_path))
    ds = get_segmentation_dataset("ade20k", root=root, crop_size=(512, 512))
    assert len(ds) == 8
    x, y = ds[0]
    assert x.shape == (512, 512, 3) and y.shape == (512, 512)
    assert 0 <= y.min() and y.max() <= 150


def test_cpu_checks_cover_the_new_families(smoke):
    """The card-vs-CPU phase holds each of the five new models at full
    width; the ResNet models' sides meet their (H - 1) % 8 == 0."""
    assert {c[0] for c in smoke.CPU_CHECKS} == {
        "SegMenter", "PSPNet", "PSPNet_DDCAT", "DeepLabV3",
        "DeepLabV3_DDCAT"}
    for name, _, _, _, side in smoke.CPU_CHECKS:
        assert name == "SegMenter" or (side - 1) % 8 == 0


def test_train_phase_inputs_and_launch_set(smoke):
    """Phase 10's batch: seeded images in [0, 1] and labels constant over
    32 x 32 regions with no ignore pixel; the kernels its launch proof
    demands are the block pair, the APGD step and the confusion
    kernel."""
    cpu = torch.device("cpu")
    x, y = smoke.train_inputs(cpu, 2, 70, 21)
    x2, y2 = smoke.train_inputs(cpu, 2, 70, 21)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert x.shape == (2, 3, 70, 70) and 0 <= x.min() and x.max() <= 1
    assert y.shape == (2, 70, 70) and y.min() >= 0 and y.max() < 21
    assert torch.equal(y[:, :32, :32], y[:, :1, :1].expand(2, 32, 32))
    assert set(smoke.TRAIN_PATH) == {"convnext_block_fwd",
                                     "convnext_block_dx", "apgd_linf_step",
                                     "confusion_matrix"}
    assert set(smoke.TRAIN_PATH) <= set(smoke.REPLACES)


def test_train_stage_shapes(smoke):
    """Phase 2 holds the block pair against its plain version at the four
    ConvNeXt stage inputs of the train path (batch 32 at 473^2), the last
    two above the fused form's width (the whole-image kernels)."""
    shapes = smoke.train_stage_shapes()
    assert shapes == [(32, 119, 119, 96), (32, 59, 59, 192),
                      (32, 29, 29, 384), (32, 14, 14, 768)]
    from robseg_torch.kernels import convnext_block as cb
    assert [cb.fused(s[-1]) for s in shapes] == [True, True, False, False]


def test_worst_case_instance(smoke):
    """Phase W's input: SEA's three attacks over ADE20K's 2000 val images
    and 151 classes, seeded, with classes absent everywhere; the
    union never below the intersection."""
    ints, unis = smoke.worst_case_instance()
    again = smoke.worst_case_instance()
    assert ints.shape == unis.shape == (3, 2000, 151)
    assert np.array_equal(ints, again[0]) and np.array_equal(unis, again[1])
    absent = (unis == 0).all(axis=(0, 1))
    assert absent.sum() == 20 and (unis >= ints).all()


def test_check_in_ball(smoke):
    """Phases N's ball and box check: Linf, L2 and L1 norms per image,
    the 1e-4 relative slack, the projection-activity floor."""
    x = torch.full((2, 3, 4, 4), 0.5)
    d = torch.zeros_like(x)
    d[0, 0, 0, :2] = 0.3  # L1 0.6, L2 0.424, Linf 0.3
    n = smoke.pert_norms(x + d, x)
    assert float(n["L1"][0]) == pytest.approx(0.6)
    assert float(n["L2"][0]) == pytest.approx(0.18 ** 0.5)
    assert float(n["Linf"][0]) == pytest.approx(0.3)
    assert smoke.check_in_ball("t", x + d, x, "L1", 0.6, active=0.9) == \
        pytest.approx(0.6)
    for kw in (dict(norm="L1", eps=0.5), dict(norm="Linf", eps=0.2),
               dict(norm="L2", eps=1.0, active=0.9)):
        with pytest.raises(AssertionError):
            smoke.check_in_ball("t", x + d, x, **kw)
    with pytest.raises(AssertionError, match="box"):
        smoke.check_in_ball("t", x + 2 * d + 0.5, x, "Linf", 10.0)


def test_fixture_ade_train_is_an_ade20k_train_tree(smoke, tmp_path):
    """Phase A's fixture reads as the port's ADE20K train (32 images, one
    size above the 1040 buffer's edge) and val (8) splits."""
    from robseg_torch.data import get_segmentation_dataset
    root = smoke.fixture_ade_train(str(tmp_path))
    train = get_segmentation_dataset("ade20k", root=root, split="train",
                                     mode="train", base_size=520,
                                     crop_size=512)
    val = get_segmentation_dataset("ade20k", root=root, crop_size=512)
    assert len(train) == 32 and len(val) == 8
    sizes = {train._load(i)[0].size for i in range(4)}
    assert max(max(s) for s in sizes) > 1040
    x, y = val[0]
    assert x.shape == (512, 512, 3) and 0 <= y.min() and y.max() <= 150


def test_engine_paths_name_kernels(smoke):
    """The launch proof of phases N, M and A: the kernels each path
    must run, all of them kernels of the kernels line."""
    for path in (smoke.NORMS_PATH, smoke.MSF_PATH, smoke.ADE_TRAIN_PATH):
        assert set(path) <= set(smoke.REPLACES)
    assert "apgd_linf_step" in smoke.NORMS_PATH
    assert "convnext_block_dx" not in smoke.MSF_PATH


def _calls(fn) -> list:
    """The names of the functions ``fn``'s body calls, in source order."""
    import ast
    import inspect
    import textwrap
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return [n.func.id for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]


def test_phase_b_runs_from_main_in_order(smoke):
    """Phase B (the train path under bf16 products) runs after the train
    path and before the engines, counts its own launches, and runs B1 to
    B5 in order; the kernels it must launch are the train path's."""
    main = _calls(smoke.main)
    order = [main.index(f) for f in ("phases_sea", "phases_train",
                                     "phases_bf16_train", "phases_engine")]
    assert order == sorted(order)
    b = _calls(smoke.phases_bf16_train)
    steps = ["phase_bf16_products", "phase_bf16_coverage",
             "phase_bf16_train_step", "phase_train_families",
             "phase_bf16_train_cli", "phase_autocast_record",
             "phase_utilities"]
    assert [f for f in b if f in steps] == steps
    assert set(smoke.BF16_TRAIN_PATH) == set(smoke.TRAIN_PATH)


def test_product_operands_sees_unrounded_operands(smoke):
    """B1's coverage check: no flag under bf16 products, one per product
    call with the mode off."""
    from robseg_torch.ops import precision
    x = torch.rand(1, 4, 9, 9, requires_grad=True)
    w = torch.rand(5, 4, 3, 3, requires_grad=True)
    with precision.bf16_products(), smoke.ProductOperands() as on:
        precision.conv2d(x, w, None, 1, 1).sum().backward()
    assert on.calls == {"convolution": 1, "convolution_backward": 1}
    assert not on.bad
    with smoke.ProductOperands() as off:
        precision.conv2d(x, w, None, 1, 1).sum().backward()
    assert len(off.bad) == 2


@pytest.mark.parametrize("cards,want", [
    (1, [(1, "nccl"), (2, "gloo")]),
    (2, [(1, "nccl"), (2, "nccl")]),
    (4, [(1, "nccl"), (2, "nccl"), (4, "nccl")]),
    (8, [(1, "nccl"), (2, "nccl"), (4, "nccl")])])
def test_data_parallel_worlds_by_card_count(smoke, cards, want):
    """Phase D's worlds: one rank over NCCL as the reference, then 2 (and
    4) ranks over NCCL with a card each, or with one card 2 ranks sharing
    it over gloo (NCCL refuses two ranks on one card)."""
    assert smoke.dp_worlds(cards) == want


@pytest.mark.parametrize("cards,want", [(0, None), (1, None), (2, (0, 1)),
                                        (4, (0, 3)), (8, (0, 7))])
def test_placement_cards(smoke, cards, want):
    """Phase P: card 0 current and the model and inputs on the last card;
    with one card (or none) there is no other card to put them on."""
    assert smoke.placement_cards(cards) == want


def _fake_cards(monkeypatch, smoke, n_cards, far_fault=None):
    """torch.cuda's card queries for ``n_cards`` cards, card 0 current, and
    a ``placement_run`` whose far run differs by ``far_fault``: a count
    of zero (``"launch"``), one histogram bin (``"hist"``) or a logit
    moved past the bound (``"logits"``). Returns the cards it ran on."""
    ran = []

    def run(dev):
        ran.append(dev)
        out = {"logits": torch.zeros(2, 21, 4, 4),
               "grad": torch.linspace(-1, 1, 96).reshape(2, 3, 4, 4),
               "adv": torch.full((2, 3, 4, 4), 0.5),
               "pred": torch.zeros(2, 4, 4, dtype=torch.long),
               "hist": torch.eye(21), "inter": torch.ones(2, 21),
               "union": torch.ones(2, 21)}
        counts = {k: 3 for k in smoke.REPLACES}
        if dev.index != 0:
            if far_fault == "launch":
                counts["apgd_linf_step"] = 0
            elif far_fault == "hist":
                out["hist"][3, 4] += 1
            elif far_fault == "logits":
                out["logits"][0, 0, 0, 0] = 0.5
        return out, counts

    monkeypatch.setattr(smoke, "placement_run", run)
    for name, fn in (("device_count", lambda: n_cards),
                     ("set_device", lambda d: None),
                     ("current_device", lambda: 0),
                     ("get_device_name", lambda d=None: "card"),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    return ran


def test_placement_runs_card_0_then_the_last(smoke, monkeypatch, capsys):
    ran = _fake_cards(monkeypatch, smoke, 4)
    counts = smoke.phase_placement()
    assert ran == [torch.device("cuda", 0), torch.device("cuda", 3)]
    assert all(counts[k] > 0 for k in smoke.PLACEMENT_PATH)
    assert "bit for bit equal" in capsys.readouterr().out


def test_placement_not_run_on_one_card(smoke, monkeypatch, capsys):
    ran = _fake_cards(monkeypatch, smoke, 1)
    assert smoke.phase_placement() is None and ran == []
    assert "placement: not run (1 card visible)" in capsys.readouterr().out


@pytest.mark.parametrize("fault,match", [
    ("launch", "never launched on cuda:1: \\['apgd_linf_step'\\]"),
    ("hist", "confusion metrics"),
    ("logits", "not close")])
def test_placement_fails_on_a_far_fault(smoke, monkeypatch, fault, match):
    _fake_cards(monkeypatch, smoke, 2, fault)
    with pytest.raises(AssertionError, match=match):
        smoke.phase_placement()


def test_placement_runs_after_phase_d(smoke):
    """Phase P runs from main after phase D and before the kernels line;
    the kernels it must launch are the main path's."""
    main = _calls(smoke.main)
    assert main.index("phase_data_parallel") < main.index("phase_placement")
    assert set(smoke.PLACEMENT_PATH) == set(smoke.MAIN_PATH)
