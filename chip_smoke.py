"""Smoke run of robseg_torch on one NVIDIA GPU: the SEA main path, and the
fused-variant attack path (MLP-tail and FPN concat-conv kernels).

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero and prints no
result line):
  1. build the CUDA kernels from robseg_torch/csrc (one nvcc per source,
     sm_90a);
  2. each kernel against its plain PyTorch version at the shapes its path
     gives it (batch 16, 512^2; plus a ragged 119^2 case; for the block
     kernels also each kernel's own time per stage from torch.profiler and
     the stage's roofline share; for the FPN
     kernels also 3 sources of (3, 40, 72, 96) with Co = 160, the channel
     and output tails, and a line naming the tile, the TMA ring and each
     shape's persistent grid), with CUDA-event times of both, the time of
     one PyTorch library call that computes the same function where there
     is one (for the MLP tail: its products, one torch.matmul each at the
     mode's operand precision), and the card's bound for the work;
  3. the full-width UperNet-ConvNeXt-T_CVST (21 classes, seeded random
     weights) on a (2, 3, 512, 512) batch: logits and the input gradient
     of sum(mask-ce-avg) against the same model with every kernel routed
     to its plain version;
  3b. the same for the fused-variant model, fused_head="pallas" with each
     of the four MLP-tail modes, and its gap to the float32 unfused model;
  4. APGD on the main path at batch 16, 512^2 (mask-ce-avg, tracking
     ce-avg, random start) for 20 and for 4 iterations: whole-run and
     marginal step*imgs/s and peak memory;
  4p. a torch.profiler account of one main-path iteration's work (a
     forward and input gradient at batch 16): kernel time by kind and the
     device's idle share;
  4b. the same for the fused-variant path (fused_mlp_mode="residual",
     fused_head="pallas") for 10 and for 4 iterations, then its profile
     as in 4p;
  5. the SEA CLI (``python -m robseg_torch.infer``) on a fixture VOC tree
     in a temporary directory, its JSON checked;
  6. the fused-variant entry point (``python -m robseg_torch.bench_fused
     --modes rs,recompute_bf16,head --batch 4 --n_iter 3``), its JSON
     checked;
  7. proof that each path launched its kernels: the main path (phases
     4-5) the block, APGD-step and confusion kernels, the fused-variant
     path (phases 4b and 6) the MLP-tail and FPN kernels, each counted
     from zero just before its path runs.
Then one JSON line of per-kernel results, and the last line
``{"ok": true, "device": {...}}``.

Tolerances. Block forward atol = rtol = 2e-2 and block input gradient max
error <= 2e-2 of its largest entry (bf16 matmul operands against the
float32 plain version, TF32 off); APGD step and confusion histogram exact.
FPN concat-conv and bf16-operand MLP tail against plain versions that
round where the kernels round: input gradient max error <= 2e-3 of its
largest entry; forward max abs error <= 1e-3 for the FPN, and max error
<= 2e-3 of its largest entry for the MLP tail, whose rounding of
gelu(h) to bf16 can go the other way where the kernel's float32 sum for
h differs from the plain one in the last bit (one such flip moves an
output by one bf16 step of one product); against the unrounded
float32 plain version the JAX package's bf16 bounds, FPN forward atol =
rtol = 5e-2 (tests/test_kernels.py:394-395), MLP forward atol = rtol =
2e-2 (:294-295), MLP gradient atol = rtol = 5e-2 (:235-236). Float32-
operand MLP tail (3xTF32) against the float32 plain version: forward atol
2e-5, gradient atol 5e-4 / rtol 1e-3 (:81-104, :142-145). Whole model:
logits atol = rtol = 2e-2 against the plain-routed model; input gradient
max error <= 0.15 of its largest entry with cosine >= 0.99 on the main
path (the JAX package's model-level bound for its block kernel,
tests/test_kernels.py:313-316); on the fused-variant path <= 2e-2 of it
with float32 MLP operands, and the same 0.15 with cosine >= 0.99 with
bf16 ones, where a rounding that goes the other way compounds through 15
blocks (measured 9.8e-2, cosine 0.99913). The fused-variant model against
the float32 unfused one under the JAX package's model-level bounds:
logits atol = rtol = 3e-2 and input gradient <= 0.05 of its largest entry
with float32 MLP operands (:432-438), <= 0.15 with cosine >= 0.99 with
bf16 ones (:313-318).

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
the card's peak for their type (989 TFLOP/s for bf16 tensor-core
products, 67 TFLOP/s for float32 arithmetic, 494.7 / 3 TFLOP/s for the
MLP tail's float32-accurate products, three TF32 tensor-core passes),
NVIDIA's H100 SXM figures.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, HW, N_CLS = 16, 512, 21
EPS = 8 / 255
REPLACES = {
    "convnext_block_fwd": "robseg_tpu/kernels/convnext_block.py:427 "
                          "(_block_fwd_call); also :313 "
                          "(_block_whole_fwd_call)",
    "convnext_block_dx": "robseg_tpu/kernels/convnext_block.py:452 "
                         "(_block_bwd_call); also :340 "
                         "(_block_whole_bwd_call)",
    "apgd_linf_step": "robseg_tpu/kernels/apgd_step.py:70",
    "confusion_matrix": "robseg_tpu/kernels/confusion.py:72",
    "fpn_concat_conv_fwd": "robseg_tpu/kernels/fpn_conv.py:152 "
                           "(_fpn_fwd_call)",
    "fpn_concat_conv_dx": "robseg_tpu/kernels/fpn_conv.py:178 "
                          "(_fpn_bwd_call)",
    "convnext_mlp_fwd": "robseg_tpu/kernels/convnext_mlp.py:165 (_call: "
                        "_fwd_kernel); also :271 (_call_save)",
    "convnext_mlp_dx": "robseg_tpu/kernels/convnext_mlp.py:165 (_call: "
                       "_bwd_kernel); also :309 (_call_resid_bwd)",
}
SOURCES = {
    "convnext_block_fwd": "robseg_torch/csrc/convnext_block.cu",
    "convnext_block_dx": "robseg_torch/csrc/convnext_block.cu",
    "apgd_linf_step": "robseg_torch/csrc/apgd_step.cu",
    "confusion_matrix": "robseg_torch/csrc/confusion.cu",
    "fpn_concat_conv_fwd": "robseg_torch/csrc/fpn_conv.cu",
    "fpn_concat_conv_dx": "robseg_torch/csrc/fpn_conv.cu",
    "convnext_mlp_fwd": "robseg_torch/csrc/convnext_mlp.cu",
    "convnext_mlp_dx": "robseg_torch/csrc/convnext_mlp.cu",
}
MAIN_PATH = ("convnext_block_fwd", "convnext_block_dx", "apgd_linf_step",
             "confusion_matrix")
FUSED_PATH = ("fpn_concat_conv_fwd", "fpn_concat_conv_dx",
              "convnext_mlp_fwd", "convnext_mlp_dx")
FUSED_MODES = ("residual", "recompute", "residual_bf16", "recompute_bf16")
HBM_BYTES_PER_S = 3.35e12
# float32-accurate products on the tensor cores: three TF32 passes
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 494.7e12 / 3}


def bound(nbytes: float, flops: dict):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(f / PEAK_FLOPS[k] for k, f in flops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def add_bound(row: dict, nbytes: float, flops: dict) -> None:
    """Add one call's bound to a row that sums several calls; the row is
    bound by what bounds the larger part of the sum."""
    ms, by = bound(nbytes, flops)
    row["bound_ms"] = row.get("bound_ms", 0.0) + ms
    parts = row.setdefault("bound_parts", {"bytes": 0.0, "operations": 0.0})
    parts[by] += ms
    row["bound_by"] = max(parts, key=parts.get)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def block_params(rng, c, dev):
    """Torch-layout block parameters; matmul weights scale with
    1/sqrt(fan-in) (tests/test_torch_cuda.py::block_params)."""
    arrs = (rng.normal(size=(c, 1, 7, 7)) * 0.1, rng.normal(size=c) * 0.1,
            rng.random(c) + 0.5, rng.normal(size=c) * 0.1,
            rng.normal(size=(4 * c, c)) * 0.5 / c ** 0.5,
            rng.normal(size=4 * c) * 0.1,
            rng.normal(size=(c, 4 * c)) / (4 * c) ** 0.5,
            rng.normal(size=c) * 0.1, rng.random(c))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def rel_max_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def kernel_split(fn, reps: int = 3) -> list:
    """Each CUDA kernel's own time in one call of ``fn`` (torch.profiler
    over ``reps`` calls after a warm-up): [(name, ms per call, launches
    per call)], longest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((ev.key, us / reps / 1e3, ev.count / reps))
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    return sorted(rows, key=lambda r: -r[1])


def short_name(name: str) -> str:
    """A profiled kernel's name without its arguments and namespaces."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out)[:80]


def block_part(name: str) -> str:
    """Which part of the block kernels a profiled kernel is."""
    if "mlp_fused_kernel" in name or "mlp_gemm_kernel" in name:
        return "mlp"
    if "dwconv_ln_kernel" in name or "dwcorr_kernel" in name:
        return "depthwise"
    if "ln_bwd_kernel" in name:
        return "ln_bwd"
    return "packing"


def phase_kernels(dev, results):
    from robseg_torch.kernels import apgd_step, confusion
    from robseg_torch.kernels import convnext_block as cb
    rng = np.random.default_rng(0)
    torch.manual_seed(0)

    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "library_ms": None, "stages": []}
    dxr = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "library_ms": None, "stages": []}
    stages = [(BATCH, 128, 128, 96), (BATCH, 64, 64, 192),
              (BATCH, 32, 32, 384), (BATCH, 16, 16, 768)]
    print(f"block kernels: fused MLP (hidden layer on chip) at C <= "
          f"{cb.FUSED_MAX_C}, two GEMMs through a bf16 hidden layer above; "
          f"{cb.TILE_M}-token tiles, {cb.HIDDEN_CHUNK}-wide hidden chunks "
          f"and K-steps, TMA + wgmma", flush=True)
    for shape in stages + [(2, 119, 119, 96)]:
        p = block_params(rng, shape[-1], dev)
        x = torch.randn(shape, device=dev)
        dy = torch.randn(shape, device=dev)
        got = cb.convnext_block_fwd_cuda(x, *p)
        want = cb.convnext_block_plain(x, *p)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        dx = cb.convnext_block_dx_cuda(x, dy, *p)
        dx_want = cb.convnext_block_dx_plain(x, dy, *p)
        torch.cuda.synchronize()
        e_dx = rel_max_err(dx, dx_want)
        if e_dx > 2e-2:
            raise AssertionError(f"block dx {shape}: rel max err {e_dx}")
        t = [cuda_ms(lambda: cb.convnext_block_fwd_cuda(x, *p)),
             cuda_ms(lambda: cb.convnext_block_plain(x, *p)),
             cuda_ms(lambda: cb.convnext_block_dx_cuda(x, dy, *p)),
             cuda_ms(lambda: cb.convnext_block_dx_plain(x, dy, *p))]
        e_fwd = float((got - want).abs().max())
        # x in and out (dx: x, dy in, dx out) f32, the f32 weights; the
        # MLP's bf16 products (3 matmuls in the dx: h, da, du) and the
        # f32 7x7 depthwise taps (twice in the dx)
        n, c = x.numel() // shape[-1], shape[-1]
        fb = (8 * n * c + 32 * c * c, {"bf16": 16 * n * c * c,
                                       "f32": 98 * n * c})
        db = (12 * n * c + 32 * c * c, {"bf16": 24 * n * c * c,
                                        "f32": 196 * n * c})
        print(f"block {shape}: fwd max_abs_err {e_fwd:.3e}, kernel "
              f"{t[0]:.3f} ms, plain {t[1]:.3f} ms, bound "
              f"{bound(*fb)[0]:.4f} ms | dx rel_max_err "
              f"{e_dx:.3e} (abs {float((dx - dx_want).abs().max()):.3e}), "
              f"kernel {t[2]:.3f} ms, plain {t[3]:.3f} ms, bound "
              f"{bound(*db)[0]:.4f} ms", flush=True)
        # each direction's kernels, one by one (torch.profiler), and the
        # stage's roofline share
        for row, name, fn, bb, tk, tp in (
                (fwd, "fwd", lambda: cb.convnext_block_fwd_cuda(x, *p), fb,
                 t[0], t[1]),
                (dxr, "dx", lambda: cb.convnext_block_dx_cuda(x, dy, *p), db,
                 t[2], t[3])):
            split = kernel_split(fn)
            parts = {}
            for kname, ms, _ in split:
                part = block_part(kname)
                parts[part] = parts.get(part, 0.0) + ms
            bms, bby = bound(*bb)
            print(f"block {shape} {name} split: " + "; ".join(
                f"{short_name(k)} {ms:.4f} ms x{n:g}" for k, ms, n in split)
                + f" | by part {json.dumps(parts)} | bound {bms:.4f} ms "
                f"({bby}), roofline share {bms / tk:.1%}", flush=True)
            row["stages"].append({
                "shape": list(shape), "ms": tk, "plain_ms": tp,
                "bound_ms": bms, "bound_by": bby, "share": bms / tk,
                "parts_ms": parts})
        fwd["max_abs_err"] = max(fwd["max_abs_err"], e_fwd)
        dxr["max_abs_err"] = max(dxr["max_abs_err"],
                                 float((dx - dx_want).abs().max()))
        if shape in stages:  # one block of each stage, summed
            fwd["ms"] += t[0]
            fwd["plain_ms"] += t[1]
            dxr["ms"] += t[2]
            dxr["plain_ms"] += t[3]
            add_bound(fwd, *fb)
            add_bound(dxr, *db)
    results["convnext_block_fwd"] = fwd
    results["convnext_block_dx"] = dxr

    shape = (BATCH, 3, HW, HW)
    x = torch.rand(shape, device=dev)
    x_adv = torch.clamp(x + (torch.rand(shape, device=dev) - 0.5) * EPS,
                        0, 1)
    x_old = torch.clamp(x + (torch.rand(shape, device=dev) - 0.5) * EPS,
                        0, 1)
    grad = torch.randn(shape, device=dev)
    step = torch.rand((BATCH, 1, 1, 1), device=dev) * 2 * EPS
    for a in (1.0, 0.75):
        got = apgd_step.apgd_linf_step_cuda(x, x_adv, x_old, grad, step,
                                            EPS, a)
        want = apgd_step.apgd_linf_step_plain(x, x_adv, x_old, grad, step,
                                              EPS, a)
        if not torch.equal(got, want):
            raise AssertionError(f"apgd step (a={a}) differs from plain: "
                                 f"{float((got - want).abs().max())}")
    t = [cuda_ms(lambda: apgd_step.apgd_linf_step_cuda(
            x, x_adv, x_old, grad, step, EPS, 0.75)),
         cuda_ms(lambda: apgd_step.apgd_linf_step_plain(
             x, x_adv, x_old, grad, step, EPS, 0.75))]
    # x, x_adv, x_old, grad in, x_next out (f32), ~10 f32 ops an element
    ab = bound(5 * 4 * x.numel() + 4 * BATCH, {"f32": 10 * x.numel()})
    print(f"apgd_linf_step {shape}: exact (bitwise equal), kernel "
          f"{t[0]:.3f} ms, plain {t[1]:.3f} ms, bound {ab[0]:.4f} ms "
          f"({ab[1]}), library: none", flush=True)
    results["apgd_linf_step"] = {"max_abs_err": 0.0, "ms": t[0],
                                 "plain_ms": t[1], "bound_ms": ab[0],
                                 "bound_by": ab[1], "library_ms": None}

    tgt = torch.randint(0, N_CLS, (BATCH, HW, HW), device=dev)
    tgt[torch.rand(tgt.shape, device=dev) < 0.05] = -1
    pred = torch.where(torch.rand(tgt.shape, device=dev) < 0.5, tgt,
                       torch.randint(0, N_CLS, tgt.shape, device=dev))
    pred = torch.where(tgt == -1, -1, pred)
    # the library yardstick: one torch.bincount of the precomputed t*K+p
    # index of the counted pixels
    idx = (tgt * N_CLS + pred)[tgt != -1]
    lib_ms = cuda_ms(lambda: torch.bincount(idx, minlength=N_CLS * N_CLS))
    if not torch.equal(torch.bincount(idx, minlength=N_CLS * N_CLS).view(
            N_CLS, N_CLS).float(), confusion.confusion_matrix_plain(
                pred, tgt, num_classes=N_CLS)):
        raise AssertionError("confusion: bincount yardstick differs")
    # pred and target int64 in, the K x K int32 histogram out
    cb_ = bound(16 * tgt.numel() + 4 * N_CLS * N_CLS, {"f32": 0})
    times = []
    for per_image in (False, True):
        kw = dict(num_classes=N_CLS, per_image=per_image)
        got = confusion.confusion_matrix_cuda(pred, tgt, **kw)
        want = confusion.confusion_matrix_plain(pred, tgt, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"confusion (per_image={per_image}) "
                                 "differs from plain")
        times.append((cuda_ms(lambda: confusion.confusion_matrix_cuda(
            pred, tgt, **kw)), cuda_ms(
                lambda: confusion.confusion_matrix_plain(pred, tgt, **kw))))
        print(f"confusion_matrix (16,512,512) K=21 per_image={per_image}: "
              f"exact, kernel {times[-1][0]:.3f} ms, plain "
              f"{times[-1][1]:.3f} ms", flush=True)
    print(f"confusion_matrix bound {cb_[0]:.4f} ms ({cb_[1]}), library "
          f"(torch.bincount) {lib_ms:.3f} ms", flush=True)
    results["confusion_matrix"] = {"max_abs_err": 0.0, "ms": times[0][0],
                                   "plain_ms": times[0][1],
                                   "bound_ms": cb_[0], "bound_by": cb_[1],
                                   "library_ms": lib_ms}


def phase_fpn(dev, results):
    """FPN concat-conv forward and input gradient at the head's shapes (4
    sources, C = Co = 512), and at a small shape whose channel (C = 96)
    and output (Co = 160) tails the kernel's TMA boxes fill with zeros."""
    import torch.nn.functional as F
    from robseg_torch.kernels import fpn_conv as fc
    rng = np.random.default_rng(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"fpn kernel: tile {fc.TILE_M} pixels x {fc.TILE_N} channels, "
          f"K-step {fc.TILE_K} channels, {fc.STAGES}-stage TMA ring, 2 "
          f"consumer warpgroups (wgmma m64n256k16) + 1 producer warpgroup, "
          f"persistent over {sms} SMs", flush=True)
    fwd = {"max_abs_err": 0.0}
    dxr = {"max_abs_err": 0.0}
    for n, shape, co in [(4, (BATCH, 128, 128, 512), 512),
                         (4, (2, 119, 119, 512), 512),
                         (3, (3, 40, 72, 96), 160)]:
        c = shape[-1]
        pf = fc.plan(*shape[:3], co, 1, sms)
        pd = fc.plan(*shape[:3], c, n, sms)
        print(f"fpn plan {n}x{shape} Co={co}: box {pf['box_w']}x"
              f"{pf['box_h']}; fwd grid {pf['blocks']} blocks over "
              f"{pf['tiles']} tiles (<= {pf['tiles_per_block']} a block), "
              f"dx grid {pd['blocks']} blocks over {pd['tiles']} tiles (<= "
              f"{pd['tiles_per_block']} a block)", flush=True)
        xs = [torch.randn(shape, device=dev) for _ in range(n)]
        w = torch.tensor(rng.normal(size=(n, 3, 3, c, co)) / 70,
                         dtype=torch.float32, device=dev)
        s = torch.tensor(1 + 0.1 * rng.normal(size=co), dtype=torch.float32,
                         device=dev)
        t = torch.tensor(0.1 * rng.normal(size=co), dtype=torch.float32,
                         device=dev)
        out = fc.fpn_concat_conv_fwd_cuda(xs, w, s, t)
        want = fc.fpn_concat_conv_fwd_plain(xs, w, s, t)
        torch.cuda.synchronize()
        e_fwd = float((out - want).abs().max())
        wfull = fc._full_weight(w)
        f32 = torch.relu(F.conv2d(torch.cat(xs, -1).permute(0, 3, 1, 2),
                                  wfull, padding=1) * s[:, None, None]
                         + t[:, None, None]).permute(0, 2, 3, 1)
        e_32 = float((out - f32).abs().max())
        close32 = bool(torch.isclose(out, f32, atol=5e-2, rtol=5e-2).all())
        del f32
        dy = torch.randn(out.shape, device=dev)
        dx = fc.fpn_concat_conv_dx_cuda(dy, out, w, s)
        dx_want = fc.fpn_concat_conv_dx_plain(dy, out, w, s)
        torch.cuda.synchronize()
        e_dx = max(rel_max_err(a, b) for a, b in zip(dx, dx_want))
        print(f"fpn_concat_conv {n}x{shape} Co={co}: fwd max_abs_err "
              f"{e_fwd:.3e} (max|out| {float(out.abs().max()):.3e}; vs "
              f"unrounded f32 {e_32:.3e}), dx rel_max_err {e_dx:.3e}",
              flush=True)
        if not (e_fwd <= 1e-3 and close32 and e_dx <= 2e-3):
            raise AssertionError(f"fpn {shape}: fwd {e_fwd}, vs f32 "
                                 f"{e_32}, dx {e_dx}")
        t_k = [cuda_ms(lambda: fc.fpn_concat_conv_fwd_cuda(xs, w, s, t)),
               cuda_ms(lambda: fc.fpn_concat_conv_fwd_plain(xs, w, s, t)),
               cuda_ms(lambda: fc.fpn_concat_conv_dx_cuda(dy, out, w, s)),
               cuda_ms(lambda: fc.fpn_concat_conv_dx_plain(dy, out, w, s))]
        # library yardsticks: one bf16 cuDNN call over the concatenated
        # channels-last input (forward) or gradient (transpose)
        xcat = torch.cat(xs, -1).to(torch.bfloat16).permute(0, 3, 1, 2)
        wbf = wfull.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        gbf = dy.to(torch.bfloat16).permute(0, 3, 1, 2)
        lib = [cuda_ms(lambda: F.conv2d(xcat, wbf, padding=1)),
               cuda_ms(lambda: F.conv_transpose2d(gbf, wbf, padding=1))]
        del xcat, gbf
        m = out.numel() // co
        flops = {"bf16": 2 * m * co * n * 9 * c}
        wbytes = 4 * w.numel()
        fb = (4 * n * m * c + 4 * m * co + wbytes, flops)
        db = (2 * 4 * m * co + 4 * n * m * c + wbytes, flops)
        print(f"fpn_concat_conv {n}x{shape} Co={co}: fwd kernel "
              f"{t_k[0]:.3f} ms, plain {t_k[1]:.3f} ms, library "
              f"{lib[0]:.3f} ms, bound {bound(*fb)[0]:.3f} ms "
              f"({bound(*fb)[1]}) | dx kernel {t_k[2]:.3f} ms, plain "
              f"{t_k[3]:.3f} ms, library {lib[1]:.3f} ms, bound "
              f"{bound(*db)[0]:.3f} ms ({bound(*db)[1]}); "
              f"{flops['bf16'] / t_k[0] / 1e9:.1f} / "
              f"{flops['bf16'] / t_k[2] / 1e9:.1f} TFLOP/s, "
              f"{bound(*fb)[0] / t_k[0]:.1%} / {bound(*db)[0] / t_k[2]:.1%} "
              "of the bound", flush=True)
        fwd["max_abs_err"] = max(fwd["max_abs_err"], e_fwd)
        dxr["max_abs_err"] = max(dxr["max_abs_err"],
                                 max(float((a - b).abs().max())
                                     for a, b in zip(dx, dx_want)))
        if shape[0] == BATCH:
            for row, tk, tp, tl, bb in ((fwd, t_k[0], t_k[1], lib[0], fb),
                                        (dxr, t_k[2], t_k[3], lib[1], db)):
                row.update(ms=tk, plain_ms=tp, library_ms=tl)
                add_bound(row, *bb)
        del xs, out, dy, dx, dx_want
    results["fpn_concat_conv_fwd"] = fwd
    results["fpn_concat_conv_dx"] = dxr


def mlp_products(y, dy, p, h, bf16, save_h):
    """The MLP tail's products as PyTorch computes them, one torch.matmul a
    product at the mode's operand precision (bf16 operands, or float32
    with TF32 off): forward u . W1^T and gelu(h) . W2^T; input gradient
    gms . W2 and dh . W1, and u . W1^T again when h is recomputed.
    Returns the forward's and the input gradient's lists of thunks."""
    from robseg_torch.kernels import convnext_mlp as cm
    ls, lb, w1, b1, w2, b2, g = p
    c = y.shape[-1]
    _, _, u = cm._layer_norm(y.reshape(-1, c), ls, lb)
    hh = h if h is not None else torch.nn.functional.linear(u, w1, b1)
    a = torch.nn.functional.gelu(hh)
    gms = (g * dy).reshape(-1, c)
    dh = torch.randn_like(hh)
    ops = [u, a, gms, dh, w1, w2]
    if bf16:
        ops = [t.to(torch.bfloat16) for t in ops]
    u, a, gms, dh, w1, w2 = ops
    fwd = [lambda: torch.matmul(u, w1.t()), lambda: torch.matmul(a, w2.t())]
    dx = [lambda: torch.matmul(gms, w2), lambda: torch.matmul(dh, w1)]
    if not save_h:
        dx.append(lambda: torch.matmul(u, w1.t()))
    return fwd, dx


def phase_mlp(dev, results):
    """MLP tail forward and input gradient, every mode, at the stage
    shapes the fused-variant path gives it (dim <= 384) and a ragged one,
    with each stage's library time (mlp_products) and bound. The JSON rows
    hold the path's own mode, residual, summed over the three stages, and
    under "modes" residual and recompute_bf16 (bench_fused's) by stage."""
    from robseg_torch.kernels import convnext_mlp as cm
    rng = np.random.default_rng(3)
    stages = [(BATCH, 128, 128, 96), (BATCH, 64, 64, 192),
              (BATCH, 32, 32, 384)]
    print(f"mlp tail kernels: bf16 operands through the block's MLP kernels "
          f"(fused at C <= 192, two GEMMs above) behind a LayerNorm pass; "
          f"float32 operands as two 3xTF32 GEMMs through an f32 h, "
          f"{cm.TF32_TILE_M}-token tiles x {cm.tf32_tile_n(4 * 96)} (4C) or "
          f"{cm.tf32_tile_n(96)} / {cm.tf32_tile_n(128)} (C = 96, 192 / "
          f"128, 256, 384) columns, {cm.TF32_K_STEP}-deep K-steps, TMA + "
          f"wgmma with A split in registers", flush=True)
    rows = {}
    for name in ("fwd", "dx"):
        rows[name] = {"max_abs_err": 0.0, "modes": {
            m: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "stages": []}
            for m in ("residual", "recompute_bf16")}}
    for shape in stages + [(2, 119, 119, 96)]:
        c = shape[-1]
        p = block_params(rng, c, dev)[2:]  # ls, lb, w1, b1, w2, b2, gamma
        ls, lb, w1, b1, w2, b2, g = p
        y = torch.randn(shape, device=dev)
        dy = torch.randn(shape, device=dev)
        want32, _ = cm.convnext_mlp_fwd_plain(y, *p)
        dx32 = cm.convnext_mlp_dx_plain(y, dy, ls, lb, w1, b1, w2, g)
        for mode in FUSED_MODES:
            save_h, bf = cm.MODES[mode]
            kw = dict(save_h=save_h, bf16_operands=bf)
            out, h = cm.convnext_mlp_fwd_cuda(y, *p, **kw)
            want, h_want = cm.convnext_mlp_fwd_plain(y, *p, **kw)
            dargs = (y, dy, ls, lb, w1, b1, w2, g)
            dx = cm.convnext_mlp_dx_cuda(*dargs, h=h, bf16_operands=bf)
            dx_want = cm.convnext_mlp_dx_plain(*dargs, h=h_want,
                                               bf16_operands=bf)
            torch.cuda.synchronize()
            e_fwd = float((out - want).abs().max())
            e_dx = rel_max_err(dx, dx_want)
            e_32 = (float((out - want32).abs().max()),
                    rel_max_err(dx, dx32))
            print(f"convnext_mlp {mode} {shape}: fwd max_abs_err "
                  f"{e_fwd:.3e} (vs f32 plain {e_32[0]:.3e}), dx "
                  f"rel_max_err {e_dx:.3e} (abs "
                  f"{float((dx - dx_want).abs().max()):.3e}; vs f32 plain "
                  f"{e_32[1]:.3e})", flush=True)
            if bf:
                ok = (rel_max_err(out, want) <= 2e-3 and e_dx <= 2e-3
                      and bool(torch.isclose(out, want32, atol=2e-2,
                                             rtol=2e-2).all())
                      and bool(torch.isclose(dx, dx32, atol=5e-2,
                                             rtol=5e-2).all()))
            else:
                ok = (e_fwd <= 2e-5
                      and bool(torch.isclose(dx, dx_want, atol=5e-4,
                                             rtol=1e-3).all()))
            if not ok:
                raise AssertionError(f"mlp {mode} {shape} out of bounds")
            t = [cuda_ms(lambda: cm.convnext_mlp_fwd_cuda(y, *p, **kw)),
                 cuda_ms(lambda: cm.convnext_mlp_fwd_plain(y, *p, **kw)),
                 cuda_ms(lambda: cm.convnext_mlp_dx_cuda(
                     *dargs, h=h, bf16_operands=bf)),
                 cuda_ms(lambda: cm.convnext_mlp_dx_plain(
                     *dargs, h=h_want, bf16_operands=bf))]
            lib_f, lib_d = mlp_products(y, dy, p, h, bf, save_h)
            lib = [sum(cuda_ms(f) for f in lib_f),
                   sum(cuda_ms(f) for f in lib_d)]
            n = y.numel() // c
            kind = "bf16" if bf else "tf32x3"
            hb = 16 * n * c if save_h else 0  # h (N, 4C) f32
            fb = (8 * n * c + hb + 32 * c * c, {kind: 16 * n * c * c})
            db = (12 * n * c + hb + 32 * c * c,
                  {kind: (16 if save_h else 24) * n * c * c})
            bf_, bd = bound(*fb), bound(*db)
            print(f"convnext_mlp {mode} {shape}: fwd kernel {t[0]:.3f} ms, "
                  f"plain {t[1]:.3f} ms, library {lib[0]:.3f} ms, bound "
                  f"{bf_[0]:.4f} ms ({bf_[1]}), share {bf_[0] / t[0]:.1%} | "
                  f"dx kernel {t[2]:.3f} ms, plain {t[3]:.3f} ms, library "
                  f"{lib[1]:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}), share "
                  f"{bd[0] / t[2]:.1%}", flush=True)
            rows["fwd"]["max_abs_err"] = max(rows["fwd"]["max_abs_err"],
                                             e_fwd)
            rows["dx"]["max_abs_err"] = max(
                rows["dx"]["max_abs_err"],
                float((dx - dx_want).abs().max()))
            if shape not in stages or mode not in rows["fwd"]["modes"]:
                continue
            for name, tk, tp, tl, bb in (("fwd", t[0], t[1], lib[0], fb),
                                         ("dx", t[2], t[3], lib[1], db)):
                row = rows[name]["modes"][mode]
                row["ms"] += tk
                row["plain_ms"] += tp
                row["library_ms"] += tl
                add_bound(row, *bb)
                bms, bby = bound(*bb)
                row["stages"].append({
                    "shape": list(shape), "ms": tk, "plain_ms": tp,
                    "library_ms": tl, "bound_ms": bms, "bound_by": bby,
                    "share": bms / tk})
    for name in ("fwd", "dx"):
        for mode, row in rows[name]["modes"].items():
            row["share"] = row["bound_ms"] / row["ms"]
            print(f"convnext_mlp {name} {mode}, 3 stages summed: kernel "
                  f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"library {row['library_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), roofline "
                  f"share {row['share']:.1%}", flush=True)
        res = rows[name]["modes"]["residual"]
        rows[name].update({k: res[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    results["convnext_mlp_fwd"] = rows["fwd"]
    results["convnext_mlp_dx"] = rows["dx"]


def build_model(dev):
    from robseg_torch.models import ModelBundle, build_model as build
    torch.manual_seed(0)
    module = build("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST",
                   N_CLS)
    return ModelBundle(module.to(dev))


def fused_model(dev, weights, **settings):
    """The model in other fused settings, with the main path's weights."""
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    module = UperNetForSemanticSegmentation("T_CVST", N_CLS, **settings)
    module.load_state_dict(weights, strict=True)
    return ModelBundle(module.to(dev)).logits_fn


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel of the model (block, MLP tail, FPN concat-conv)
    through its plain version (the comparison models of phases 3 and 3b;
    the package itself has no such switch)."""
    import robseg_torch.models.convnext as convnext_mod
    import robseg_torch.models.upernet as upernet_mod
    from robseg_torch.kernels.convnext_block import convnext_block_plain
    from robseg_torch.kernels.convnext_mlp import convnext_mlp_plain
    from robseg_torch.kernels.fpn_conv import fpn_concat_conv_plain
    swaps = [(convnext_mod, "convnext_block", convnext_block_plain),
             (convnext_mod, "convnext_mlp", convnext_mlp_plain),
             (upernet_mod, "fpn_concat_conv", fpn_concat_conv_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_model(dev, logits_fn):
    from robseg_torch.ops.losses import ATTACK_CRITERIA
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((2, 3, HW, HW), device=dev, generator=g)
    with torch.no_grad():
        lk = logits_fn(x)
        with plain_kernels():
            lp = logits_fn(x)
    e_l = float((lk - lp).abs().max())
    # labels: the model's argmax on about half the pixels (a non-empty
    # mask-ce-avg mask), restricted to pixels whose top-2 gap exceeds the
    # logit error so both models agree on the mask; elsewhere the
    # lowest-scoring class, which neither model predicts
    top2 = lk.topk(2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * e_l
    pick = sure & (torch.rand(sure.shape, device=dev, generator=g) < 0.5)
    lab = torch.where(pick, lk.argmax(1), lk.argmin(1))

    def input_grad():
        xg = x.clone().requires_grad_(True)
        loss = ATTACK_CRITERIA["mask-ce-avg"](logits_fn(xg), lab).sum()
        return torch.autograd.grad(loss, xg)[0]

    gk = input_grad()
    with plain_kernels():
        gp = input_grad()
    e_g = rel_max_err(gk, gp)
    cos = float(torch.nn.functional.cosine_similarity(
        gk.flatten(), gp.flatten(), dim=0))
    print(f"model (2,3,512,512): logits max_abs_err {e_l:.3e} (max|logit| "
          f"{float(lp.abs().max()):.3e}), argmax agreement "
          f"{float((lk.argmax(1) == lp.argmax(1)).float().mean()):.5f}, "
          f"mask-ce-avg pixels {int(pick.sum())}, input-grad rel_max_err "
          f"{e_g:.3e}, cosine {cos:.6f}", flush=True)
    torch.testing.assert_close(lk, lp, atol=2e-2, rtol=2e-2)
    # through all 18 blocks the bf16 rounding of each block's matmul
    # operands compounds; the bound is the JAX package's own for a model
    # run through its block kernel (tests/test_kernels.py:313-316)
    if not (math.isfinite(e_g) and e_g <= 0.15 and cos >= 0.99):
        raise AssertionError(f"model input grad: rel max err {e_g}, "
                             f"cosine {cos}")


def phase_fused_model(dev, weights):
    """The fused-variant model (fused_head="pallas", each MLP-tail mode)
    against itself with every kernel routed to its plain version, and its
    gap to the float32 unfused model."""
    from robseg_torch.ops.losses import ATTACK_CRITERIA
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((2, 3, HW, HW), device=dev, generator=g)
    f32_fn = fused_model(dev, weights, fused_mlp=False, fused_head=False)
    with torch.no_grad():
        lf = f32_fn(x)
    # labels: the float32 model's argmax on about half of the pixels whose
    # top-2 gap is wide (>= 0.1, or the widest tenth) against logit errors
    # of a few 1e-2 at most, so every model agrees on the mask-ce-avg mask;
    # elsewhere the lowest-scoring class, which no model predicts
    top2 = lf.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).flatten()
    margin = min(0.1, float(gap.kthvalue(int(0.9 * gap.numel())).values))
    sure = (top2[:, 0] - top2[:, 1]) >= margin
    pick = sure & (torch.rand(sure.shape, device=dev, generator=g) < 0.5)
    lab = torch.where(pick, lf.argmax(1), lf.argmin(1))

    def run(fn):
        xg = x.clone().requires_grad_(True)
        logits = fn(xg)
        loss = ATTACK_CRITERIA["mask-ce-avg"](logits, lab).sum()
        return logits.detach(), torch.autograd.grad(loss, xg)[0]

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0))

    lf, gf = run(f32_fn)
    for mode in FUSED_MODES:
        fn = fused_model(dev, weights, fused_mlp_mode=mode,
                         fused_head="pallas")
        lk, gk = run(fn)
        with plain_kernels():
            lp, gp = run(fn)
        e = (float((lk - lp).abs().max()), rel_max_err(gk, gp),
             float((lk - lf).abs().max()), rel_max_err(gk, gf))
        print(f"fused model {mode}+pallas (2,3,512,512): vs plain-routed: "
              f"logits max_abs_err {e[0]:.3e}, input-grad rel_max_err "
              f"{e[1]:.3e}, cosine {cos(gk, gp):.6f} | vs float32 unfused: "
              f"logits max_abs_err {e[2]:.3e}, input-grad rel_max_err "
              f"{e[3]:.3e}, cosine {cos(gk, gf):.6f} (mask-ce-avg pixels "
              f"{int(pick.sum())}, margin {margin:.3f})", flush=True)
        torch.testing.assert_close(lk, lp, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lk, lf, atol=3e-2, rtol=3e-2)
        # bf16 MLP operands: through 15 blocks a rounding that goes the
        # other way in one model compounds, so the gradient is held to the
        # JAX package's model-level bf16 bound against both models
        bf = mode.endswith("_bf16")
        ok_p = (e[1] <= 0.15 and cos(gk, gp) >= 0.99) if bf else e[1] <= 2e-2
        ok_f = (e[3] <= 0.15 and cos(gk, gf) >= 0.99) if bf else e[3] <= 0.05
        if not (math.isfinite(e[1]) and ok_p):
            raise AssertionError(f"{mode}: input grad vs plain-routed {e[1]}"
                                 f", cosine {cos(gk, gp)}")
        if not (math.isfinite(e[3]) and ok_f):
            raise AssertionError(f"{mode}: input grad vs float32 model "
                                 f"{e[3]}, cosine {cos(gk, gf)}")


def phase_apgd(dev, logits_fn, n_iter=20, label="main path"):
    from robseg_torch.attacks.apgd import apgd_attack
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((BATCH, 3, HW, HW), device=dev, generator=g)
    y = torch.randint(0, N_CLS, (BATCH, HW, HW), device=dev, generator=g)

    def run(it):
        res = apgd_attack(logits_fn, x, y, norm="Linf", eps=EPS, n_iter=it,
                          use_rs=True, loss="mask-ce-avg",
                          track_loss="ce-avg", n_iter_buf=n_iter,
                          generator=torch.Generator(device=dev).manual_seed(
                              1))
        res.acc.cpu()  # waits for the device
        return res

    torch.cuda.reset_peak_memory_stats(dev)
    res = run(n_iter)
    if not (bool(torch.isfinite(res.x_best_adv).all())
            and float((res.x_best_adv - x).abs().max()) <= EPS + 1e-6):
        raise AssertionError("APGD result outside the eps ball or not finite")
    run(4)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        run(4)
    t1 = time.perf_counter()
    for _ in range(reps):
        run(n_iter)
    t2 = time.perf_counter()
    whole = n_iter * BATCH / ((t2 - t1) / reps)
    per_iter = ((t2 - t1) - (t1 - t0)) / reps / (n_iter - 4)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"apgd {label} (16,3,512,512) mask-ce-avg/ce-avg rs: whole-run "
          f"{whole:.2f} step*imgs/s, marginal {BATCH / per_iter:.2f} "
          f"step*imgs/s ({per_iter * 1e3:.1f} ms/iteration), {n_iter}-iter "
          f"run {(t2 - t1) / reps:.2f} s, peak memory {peak / 2**30:.2f} "
          f"GiB, final mean acc {float(res.acc.mean()):.4f}", flush=True)


def kernel_kind(name: str, tail: bool = False) -> str:
    """The kind of a profiled kernel, for a path's time account. On the
    fused-variant path (``tail``) no block kernel runs, so the MLP
    kernels, packing and LayerNorm backward the two share are the MLP
    tail's."""
    part = block_part(name)
    if "mlp_tf32_kernel" in name or "ln_rows_kernel" in name or (
            tail and part != "depthwise"
            and ("pack_kernel" in name or part != "packing")):
        return "MLP tail"
    if any(k in name for k in ("fpn_gemm_kernel", "to_bf16_kernel",
                               "relu_grad_kernel")):
        return "FPN concat-conv"
    if part != "packing":
        return f"block {part}"
    low = name.lower()
    if "norm" in low or "bn_" in low:
        return "elementwise, norms, resize, loss"
    # cuDNN's kernels name the convolution pass (fprop, dgrad, wgrad) or
    # an implicit GEMM; cuBLAS's are plain gemm kernels (sm90_xmma_gemm_..)
    if any(k in low for k in ("cudnn", "conv", "dgrad", "wgrad", "fprop",
                              "implicit")):
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "apgd" in low or "confusion" in low:
        return "APGD step, confusion"
    return "elementwise, norms, resize, loss"


def phase_profile(dev, logits_fn, label: str = "main-path",
                  tail: bool = False, reps: int = 2):
    """Where one APGD iteration's device time goes on a path: ``reps``
    forward + input-gradient passes of the model at batch 16 (the work of
    one iteration) under torch.profiler, kernel time by kind and the
    device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from robseg_torch.ops.losses import ATTACK_CRITERIA
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((BATCH, 3, HW, HW), device=dev, generator=g)
    y = torch.randint(0, N_CLS, (BATCH, HW, HW), device=dev, generator=g)

    def step():
        xg = x.clone().requires_grad_(True)
        loss = ATTACK_CRITERIA["mask-ce-avg"](logits_fn(xg), y).sum()
        return torch.autograd.grad(loss, xg)[0]

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kinds, top = {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        ms = us / reps / 1e3
        kind = kernel_kind(ev.key, tail)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        top.append((ms, short_name(ev.key), ev.count // reps))
    busy = sum(kinds.values())
    print(f"{label} profile, one forward + input gradient at batch 16: "
          f"{wall:.1f} ms wall, {busy:.1f} ms of kernels, idle share "
          f"{max(0.0, 1 - busy / wall):.4f}; by kind: " + "; ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"{label} profile, top kernels: " + "; ".join(
        f"{n} {ms:.2f} ms x{c}" for ms, n, c in sorted(top, reverse=True)[
            :12]), flush=True)


def phase_cli(tmp: str) -> dict:
    import yaml
    root = os.path.join(tmp, "voc")
    subprocess.run([sys.executable, os.path.join(
        REPO, "tools", "make_fixture_dataset.py"), "--root", root,
        "--n_train", "0", "--n_val", "8"], check=True)
    with open(os.path.join(REPO, "configs", "rig_voc_demo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"]["ROOT"] = root
    cfg["SAVE_DIR"] = os.path.join(tmp, "out")
    cfg_path = os.path.join(tmp, "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "robseg_torch.infer", "--cfg",
                        cfg_path, "--eps", "8", "--n_iter", "10",
                        "--n_batches", "1"], cwd=REPO, capture_output=True,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"SEA CLI exited {p.returncode}:\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    out = p.stdout
    outs = [f for f in os.listdir(cfg["SAVE_DIR"])
            if f.startswith("worse_SEA_") and f.endswith(".json")]
    if len(outs) != 1:
        raise AssertionError(f"expected one worse_SEA_*.json, got {outs}")
    with open(os.path.join(cfg["SAVE_DIR"], outs[0])) as f:
        res = json.load(f)

    def numbers(v):
        if isinstance(v, dict):
            return [n for u in v.values() for n in numbers(u)]
        if isinstance(v, list):
            return [n for u in v for n in numbers(u)]
        return [float(v)]
    if not all(math.isfinite(n) for n in numbers(res)):
        raise AssertionError(f"non-finite number in {outs[0]}")
    if res["final_miou"] > min(res["loss-wise_miou"]) + 1e-6:
        raise AssertionError("final_miou above a loss-wise mIoU")
    checks = re.findall(r"batch \d+: max Linf pert: ([0-9.e+-]+), nan in "
                        r"imgs: (\d+), max in imgs: ([0-9.e+-]+), min in "
                        r"imgs: ([0-9.e+-]+)", out)
    if len(checks) != 3:
        raise AssertionError(f"expected 3 check_imgs lines, got {checks}")
    for pert, nan, hi, lo in checks:
        # printed with 5 decimals
        if not (float(pert) <= EPS + 1e-5 and int(nan) == 0
                and float(hi) <= 1.0 and float(lo) >= 0.0):
            raise AssertionError(f"adversarial images out of bounds: "
                                 f"{pert} {nan} {hi} {lo}")
    m = re.search(r"^kernel launches: (\{.*\})$", out, re.M)
    if m is None:
        raise AssertionError("SEA CLI printed no kernel launch counts")
    counts = json.loads(m.group(1))
    print(f"SEA CLI (8 VOC fixture images at 473^2, batch 8, n_iter 10) in "
          f"{time.time() - t0:.1f} s: clean {res['clean']}, worst_Acc "
          f"{res['worst_Acc']:.4f}, final_miou {res['final_miou']:.4f}, "
          f"loss-wise mIoU {res['loss-wise_miou']}; max Linf pert "
          f"{max(float(c[0]) for c in checks):.5f} <= {EPS:.5f}; "
          f"launches {counts}", flush=True)
    return counts


def phase_bench_fused() -> dict:
    """The fused-variant entry point as a user runs it; returns its kernel
    launch counts."""
    modes = ["rs", "recompute_bf16", "head"]
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "robseg_torch.bench_fused",
                        "--modes", ",".join(modes), "--batch", "4",
                        "--n_iter", "3"], cwd=REPO, capture_output=True,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"bench_fused exited {p.returncode}:\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    want = ([f"fwd_full_{m}_ms" for m in modes + ["recompute"]]
            + [f"attack_step_imgs_per_s_{m}" for m in modes]
            + [f"attack_acc_{m}" for m in modes])
    if sorted(res) != sorted(want):
        raise AssertionError(f"bench_fused keys {sorted(res)}")
    if not all(math.isfinite(v) and v > 0 for k, v in res.items()
               if not k.startswith("attack_acc_")):
        raise AssertionError(f"bench_fused: times and rates {res}")
    if not all(0.0 <= res[f"attack_acc_{m}"] <= 1.0 for m in modes):
        raise AssertionError(f"bench_fused: accuracies {res}")
    m = re.search(r"^kernel launches: (\{.*\})$", p.stdout, re.M)
    if m is None:
        raise AssertionError("bench_fused printed no kernel launch counts")
    counts = json.loads(m.group(1))
    print(f"bench_fused (--modes {','.join(modes)} --batch 4 --n_iter 3) "
          f"in {time.time() - t0:.1f} s: {json.dumps(res)}; launches "
          f"{counts}", flush=True)
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(2)
    from robseg_torch import kernels
    from robseg_torch.infer import set_numerics
    from robseg_torch.kernels import _build

    dev = torch.device("cuda")
    set_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.time()
    path = _build.build()
    print(f"build: {time.time() - t0:.1f} s ({os.path.relpath(path, REPO)})",
          flush=True)

    results = {}
    phase_kernels(dev, results)
    phase_fpn(dev, results)
    phase_mlp(dev, results)
    bundle = build_model(dev)
    phase_model(dev, bundle.logits_fn)
    weights = bundle.module.state_dict()
    phase_fused_model(dev, weights)

    # each path counted from zero: the main path (APGD and the SEA CLI),
    # then the fused-variant path (APGD and its bench entry point)
    kernels.reset_launch_counts()
    phase_apgd(dev, bundle.logits_fn)
    main_counts = kernels.launch_counts()
    phase_profile(dev, bundle.logits_fn)
    fused_fn = fused_model(dev, weights, fused_mlp_mode="residual",
                           fused_head="pallas")
    kernels.reset_launch_counts()
    phase_apgd(dev, fused_fn, n_iter=10, label="fused-variant path")
    fused_counts = kernels.launch_counts()
    phase_profile(dev, fused_fn, label="fused-variant-path", tail=True)
    del fused_fn
    with tempfile.TemporaryDirectory() as tmp:
        for name, n in phase_cli(tmp).items():
            main_counts[name] += n
    for name, n in phase_bench_fused().items():
        fused_counts[name] += n
    print(f"main-path launches: {main_counts}", flush=True)
    print(f"fused-variant-path launches: {fused_counts}", flush=True)
    launches = {name: (main_counts if name in MAIN_PATH else
                       fused_counts)[name] for name in REPLACES}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "stages", "modes")
            if k in results[name]}}
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
