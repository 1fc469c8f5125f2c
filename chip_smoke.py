"""Smoke run of robseg_torch on one NVIDIA GPU: the SEA main path, the
fused-variant attack path (MLP-tail and FPN concat-conv kernels), the
``--precision bf16`` path (the bf16 I/O forms of the block and FPN
kernels), the SEA path of the Segmenter-ViT and PSPNet/DeepLab
families (the APGD-step and confusion kernels), the PIR-AT train
path (the block pair in the attack's twin, the APGD-step kernel under
``TRAIN.ATTACK: apgd``, the confusion kernel in the evaluations), the
same train path under bf16 products (the train CLI's ``--precision bf16``
and ``TRAIN.AMP``), the worst-case engines, the L2/L1/restart/filter
attacks, multi-scale + flip evaluation and ADE20K training with
on-device augmentation.

    python3 chip_smoke.py

Numerics: the paths run as a user runs them, under the CLI's
``set_numerics`` (TF32 in cuBLAS and cuDNN outside the kernels, the
reference's default numerics class). Every phase that holds a kernel
against its plain version, or a model against its plain-routed self,
runs inside ``strict_float32()``: TF32 off, so the plain versions'
products are float32 and the tolerances below mean what they say.

Phases (any failure raises, so the process exits non-zero and prints no
result line):
  1. build the CUDA kernels from robseg_torch/csrc (one nvcc per source,
     sm_90a) by a world of 2 ranks (NCCL, a card each, or gloo sharing
     one card) that start with the empty ``_build/`` and compile at once,
     each launching the confusion kernel after;
  2. (TF32 off) each kernel against its plain PyTorch version at the
     shapes its path
     gives it (batch 16, 512^2; plus a ragged 119^2 case, and for the
     block pair the four stages of the train path, batch 32 at 473^2:
     119^2, 59^2, 29^2, 14^2, the last two in the whole-image form; for the block
     kernels also each kernel's own time per stage from torch.profiler and
     the stage's roofline share; for the FPN
     kernels also 3 sources of (3, 40, 72, 96) with Co = 160, the channel
     and output tails, and a line naming the tile, the TMA ring and each
     shape's persistent grid), with CUDA-event times of both, the time of
     one PyTorch library call that computes the same function where there
     is one (for the MLP tail: its products, one torch.matmul each at the
     mode's operand precision), and the card's bound for the work;
     The confusion kernel at 16 x 512^2 with K = 21 and 151 (its shared
     form), 239, 300, 459, 847 and 673 (its global form; each case's
     kernel checked against the form ``plan`` chose, in the profiler's
     list), random and blocky (32 x 32 regions) labels, summed and per
     image: bit for bit against its plain version, torch.bincount and, at
     K = 21 and 151, its first design, with the times of each and their
     device times (the kernels and the memset that zeroes the output);
     then ``iou_acc_summary`` and ``per_image_intersect_union`` at K = 847
     on the card against the same calls on the CPU;
  2b. (TF32 off) the bf16 I/O forms of the block pair (the four stages and
     2 x 119 x 119 x 96) and the FPN pair (4 x (16, 128, 128, 512)): each
     bit for bit equal to its float32 form on the upcast inputs with the
     result rounded once to bf16, and held against its plain version on
     the same bf16 inputs, with times, bounds (bytes at 2 bytes an
     element) and, for the FPN, one bf16 cuDNN call; the block forward's
     device split by kernel (the packing, dwconv_ln, the MLP kernel or
     kernels), each beside its own bound, the MLP's GELU floor (n 4C exact
     GELUs at GELU_INSTRUCTIONS float32 instructions) and the call's time
     (``fwd device split`` lines; phase 2 prints them for the float32
     form);
  3. (TF32 off) the full-width UperNet-ConvNeXt-T_CVST (21 classes,
     seeded random weights) on a (2, 3, 512, 512) batch: logits and the
     input gradient of sum(mask-ce-avg) against the same model with every
     kernel routed to its plain version;
  3b. (TF32 off) the same for the fused-variant model, fused_head="pallas"
     with each of the four MLP-tail modes, and its gap to the float32
     unfused model;
  3c. (TF32 off) the same for the bf16 main-path model
     (``ModelBundle(..., "bf16")``), float32 logits;
  3d. (TF32 off) each new family's model at full width (Segmenter
     ViT-S/16 with 151 classes on 473^2; PSPNet, PSPNet-DDCAT, DeepLabV3
     and DeepLabV3-DDCAT with 21 classes on 257^2), batch 1: logits and
     the input gradient of sum(mask-ce-avg) on the card against the same
     module on the CPU, in float32 and float64, at most 1e-3 of the
     largest entry (the ResNet models' float32 gradient: cosine >= 0.9999,
     see ``phase_family_vs_cpu``);
  4. APGD on the main path at batch 16, 512^2 (mask-ce-avg, tracking
     ce-avg, random start) for 20 and for 4 iterations (2 timed runs
     each): whole-run and marginal step*imgs/s and peak memory;
  4p. a torch.profiler account of one main-path iteration's work (a
     forward and input gradient at batch 16): kernel time by kind and the
     device's idle share;
  4b. the same for the fused-variant path (fused_mlp_mode="residual",
     fused_head="pallas") for 10 and for 4 iterations, then its profile
     as in 4p;
  4c. the same as 4 and 4p for the bf16 main path;
  5. the SEA CLI (``python -m robseg_torch.infer``) on a fixture VOC tree
     in a temporary directory, its JSON checked, with ``--precision
     default`` and with ``--precision bf16``;
  6. the fused-variant entry point (``python -m robseg_torch.bench_fused
     --modes rs,recompute_bf16,head --batch 4 --n_iter 3``), and with
     ``--bf16 --modes head,rs``, its JSON checked;
  7. proof that each path launched its kernels: the main path (phases
     4 and 5) the block, APGD-step and confusion kernels, the
     fused-variant path (phases 4b and 6) the MLP-tail and FPN kernels,
     the bf16 path (phases 4c, 5 with bf16 and 6 with --bf16) the bf16
     forms of the block and FPN kernels, each counted from zero just
     before its path runs;
  8. the attacked-metric probe of tools/bench_bf16.py: apgd_largereps
     (mask-ce-avg, early stop, PROBE_ITERS iterations) on one fixed batch
     of 8 fixture VOC images at 512^2, eps 4/255 and 8/255 (and 0.5/255,
     below where a random-init model falls to ~0 accuracy), under strict
     float32 (TF32 off), the default numerics and bf16; the default model
     scores every mode's adversarial examples; prints the aAcc and mIoU
     deltas of bf16 against default and of default against strict;
  9. the families' path, counted from zero: APGD at batch 16 (as in 4) on
     Segmenter ViT-S/16 (512^2, 151 classes) and PSPNet-R50 (473^2, 21
     classes) under default and bf16 and on Segmenter-SAM (ViT-B/16) under
     default, then the SEA CLI with configs/voc_pspnet.yaml on the VOC
     fixture and with configs/ade20k_segmenter.yaml (bf16) on an ADE20K
     fixture tree (``fixture_ade``), eps 4 and 8, each JSON checked; the
     APGD-step and confusion kernels must have launched;
  9p. a torch.profiler account of one iteration's work on each of those
     models (forward, input gradient, APGD step), by the PyTorch op that
     launched each kernel: attention matmuls, softmax, other matmuls
     (linear layers, resizes), cuDNN convolutions, elementwise work, norms
     and the loss, the APGD step; and the idle share;
 10. the train path under the CLI's numerics (TF32):
     10t. (TF32 off, before the count) the fused-attack trainer after one
          step, batch 32 at 473^2: the twin's logits and the input
          gradient of the PGD loss against the plain module's on the same
          parameters and BatchNorm statistics (phase 3's bounds), and
          PGD-5 through each (the share of equal entries, the loss each
          reaches on the plain module, which must exceed the clean loss);
          a backward through the twin with weights that require grad must
          raise;
     then, counted from zero (the train CLI's printed counts added):
     10a. the full-width UperNet-ConvNeXt-T_CVST train step (21 classes,
          473^2, batch 32, AdamW lr 1e-4 wd 0.05 warmuppolylr, PGD-5 at
          eps 4/255, alpha 1e-2; seeded random images, blocky labels) with
          the attack through the block kernels' twin and through the
          plain module: 2 warm-up and 6 timed steps each, s/step, train
          images/s, peak memory; a torch.profiler split of one step
          (attack, update forward+backward, optimizer) by kind with idle
          shares; every parameter and BatchNorm statistic must move; one
          eval step;
     10b. one step with TRAIN.ATTACK apgd;
     10c. ``python -m robseg_torch.train`` on a fixture VOC tree (48
          train, 8 val images; batch 8, eval every epoch on one batch)
          for 12 iterations with --fused_attack, --resume to 14; then the
          SEA CLI on its best_model.pth at eps 4 (its launches printed on
          their own, not counted as the train path's);
     10d. 3 train steps at batch 8 on PSPNet-R50 (voc_pspnet.yaml, SGD
          with x10 head scales, 473^2) and Segmenter ViT-S/16
          (ade20k_segmenter.yaml, 512^2, 151 classes), full width: s/step,
          peak memory, finite losses;
     the block pair, the APGD-step and the confusion kernels must have
     launched on it (``launches_train_path`` in the kernels line).
  B. the train path under bf16 products (``robseg_torch/ops/precision.py``,
     JAX's ``jax_default_matmul_precision=bfloat16``):
     B1. each product under the mode (matmuls as bf16 cuBLAS products with
         a float32 output, convolutions on bf16-rounded float32 operands
         under TF32) against float64 on the same rounded operands, the
         forward and both operands' gradients from a rounded cotangent,
         each within 1e-3 of the reference's largest entry: the stem's
         3x3/s2 conv on RGB, a stage-1 depthwise 7x7, a 3x3 2048 -> 512 at
         119^2 (batch 2), a 384 -> 1536 linear layer, the Segmenter's
         1025-token q k^T and a 119 -> 473 resize product, with the ms of
         each (forward and both gradients) beside ``default``; then the CPU
         test's coverage check on the plain UperNet at batch 2, 473^2 (a
         TorchDispatchMode sees only bf16-representable operands in every
         product call of a train loss and backward and of an eval input
         gradient; the same run with the mode off must trip it);
     then, counted from zero (the train CLI's printed counts added):
     B2. 10a's step (fused twin) under the mode: 2 warm-up and 6 timed
         steps, s/step, train images/s and peak beside 10a's ``default``
         step, the first 4 losses of both from the same seed and weights,
         every parameter moved, its profile as in 10a; one TRAIN.ATTACK
         apgd step under the mode;
     B3. 10d's PSPNet-R50 and Segmenter ViT-S/16 steps at batch 8 under
         the mode (one warm-up, one timed);
     B4. ``python -m robseg_torch.train --fused_attack`` on a fixture VOC
         tree (16 train, 8 val images, batch 8) for 2 iterations with
         ``--precision bf16``, then with ``TRAIN.AMP: true`` under
         ``default``: rc 0, ``precision: bf16`` and a finite loss logged,
         best_model.pth written;
     the block pair, the APGD-step and the confusion kernels must have
     launched on it (``launches_bf16_train_path``); after the count, for
     the record only, one plain-attack step under torch.autocast(bf16)
     (not a mode of the CLI); and
     B5. ``utils.profiling.trace`` around one main-path APGD iteration
         writes a Chrome trace with CUDA kernel events; ``utils.flops.
         cost_analysis`` of the plain UperNet forward at batch 16, 512^2.
  W. the worst-case engines: ``libworst_case`` built with g++ from
     robseg_torch/native/worst_case.cpp, then native (and auto), python,
     reference and reference-python on seeded (A, N, K) = (3, 2000, 151)
     with absent classes, each engine's seconds; the native minimum within
     0.02 of the Python one and not above the start, the reference pair
     trajectory-identical, auto = native;
  N. the norms, counted from zero, on the main path's model (batch 16,
     512^2, 21 classes, mask-ce-avg tracking ce-avg, no random start):
     run_attack_over_loader refuses L2 and L1 as the JAX function does
     (apgd_largereps projects in Linf only), so apgd_attack runs them
     (L2 eps 4, L1 eps 64; 10 and 4 iterations: whole-run and marginal
     step*imgs/s), each inside its ball and [0, 1] with the projection
     active; run_attack_over_loader under Linf; apgd_restarts with
     ce-targeted, 2 restarts x 10 Linf iterations; pgd_filters, 10
     iterations; iou_acc_summary of each, and no attacked per-image
     accuracy above the clean one; the block pair, APGD-step and
     confusion kernels must have launched;
  M. multi-scale + flip: multi_scale_flip_logits on 8 fixture VOC images
     at 473^2 (scales 256, 384, 480, 608, 736 and their flips) against the
     same call with every kernel plain (TF32 off; phase 3's logits bound on
     the summed probabilities), then the SEA CLI with ``--no-adversarial
     --msf`` and configs/pascalvoc_convnext.yaml on the fixture (wall time,
     stats); the CLI's block forward and confusion launches must be
     non-zero;
  A. ADE20K training with TRAIN.DEVICE_AUG: augment_batch's ms a batch-16
     call from 1040^2 buffers (an ADE20K-layout fixture with a train
     split, ``fixture_ade_train``) beside the host pipeline's and
     load_raw_batch's ms a batch; configs/ade20k_convnext.yaml's step (151
     classes, batch 16, 512^2, PGD-20 at eps 4/255 through the block
     kernels' twin, AdamW) on such batches: 2 warm-up and 4 timed steps,
     s/step, train images/s, peak memory, an eval step; the train CLI with
     DEVICE_AUG: true at batch 8 for 4 iterations (an eval, a checkpoint)
     and --resume to 5; counted from zero, the block pair and the
     confusion kernel must have launched.
  D. data parallelism (``robseg_torch/parallel``), counted from zero in
     every rank: 10a's train step (fused attack, global batch 32 at
     473^2) on 2 ranks (and 4) over NCCL with a card each or, with one
     card, 2 ranks sharing it over gloo; 2 warm-up and 2 timed steps,
     s/step (the slowest rank's; world 1's is 10a's), train images/s,
     peak memory per rank, an eval step, the gradient all-reduce timed
     alone (host clock between syncs, median of 3). Held against one-rank
     steps in a world of one over NCCL (this process): each rank's first
     loss on its shard within 1e-4 of a one-rank step on that shard with
     that rank's draws, the mean first loss within 1e-2 of 10a's; every
     parameter moved, the replicas identical. Then the ``--shard`` SEA
     CLI under torchrun with the largest world's ranks on the VOC
     fixture: its JSON within 1e-3 of phase 5's unsharded run, every
     image's aAcc and intersection/union counts in its ``argmax-logs``
     equal to those of its gathered predictions and labels (each row its
     image's), every adversarial batch inside its eps ball; the block pair,
     the APGD-step and the confusion kernels must have launched
     (``launches_data_parallel_path`` in the kernels line).
Each phase prints its seconds. Then one JSON line of per-kernel results,
and the last line
``{"ok": true, "device": {...}}``.

The torch.profiler splits (per kernel, per kind of work) only divide time
that CUDA events measure: a profiler window with no device time in it is
taken again, and a split that stays empty is printed as not measured
rather than failing the run.

Tolerances. Block forward atol = rtol = 2e-2 and block input gradient max
error <= 2e-2 of its largest entry (bf16 matmul operands against the
float32 plain version, TF32 off); APGD step and confusion histogram exact;
the metrics at K = 847 on the card against the CPU: histograms,
intersections and unions exact, (mAcc, aAcc, mIoU) to 1e-6 (float32 means
over 847 classes summed in another order).
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
2e-5, gradient atol 5e-4 / rtol 1e-3 (:81-104, :142-145). The bf16 I/O
forms of the block and FPN kernels against their float32 forms on the
upcast inputs, rounded once to bf16: bit for bit; against the plain
version on the same bf16 inputs (float32 math, one rounding at the
output), the float32 form's bound plus one bf16 step of the entry (rtol
2^-7). Whole model:
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
bf16 ones (:313-318). The bf16 model against its plain-routed self under
the JAX package's bf16 bounds: logits atol = rtol = 5e-2 (:335-336),
input gradient <= 0.15 of its largest entry (:313-318), with cosine
>= 0.99.

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
the card's peak for their type (989 TFLOP/s for bf16 tensor-core
products, 67 TFLOP/s for float32 arithmetic, 494.7 / 3 TFLOP/s for the
MLP tail's float32-accurate products, three TF32 tensor-core passes),
NVIDIA's H100 SXM figures.
"""

from __future__ import annotations

import ast
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
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, HW, N_CLS = 16, 512, 21
N_ADE = 151  # ADE20K's classes
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
BF16_FORMS = ("convnext_block_fwd", "convnext_block_dx",
              "fpn_concat_conv_fwd", "fpn_concat_conv_dx")
for _k in BF16_FORMS:
    REPLACES[_k + "_bf16"] = REPLACES[_k] + ", bf16 I/O form"
    SOURCES[_k + "_bf16"] = SOURCES[_k]
MAIN_PATH = ("convnext_block_fwd", "convnext_block_dx", "apgd_linf_step",
             "confusion_matrix")
FUSED_PATH = ("fpn_concat_conv_fwd", "fpn_concat_conv_dx",
              "convnext_mlp_fwd", "convnext_mlp_dx")
BF16_PATH = tuple(k + "_bf16" for k in BF16_FORMS)
# the Segmenter and PSPNet/DeepLab families run no kernel of their own;
# their SEA path runs these two
FAMILIES_PATH = ("apgd_linf_step", "confusion_matrix")
PROBE_ITERS = 50  # tools/bench_bf16.py's n_iter
FUSED_MODES = ("residual", "recompute", "residual_bf16", "recompute_bf16")
HBM_BYTES_PER_S = 3.35e12
# float32-accurate products on the tensor cores: three TF32 passes
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 494.7e12 / 3}
# float32 instructions of one exact GELU on the CUDA cores (the bias, erff's
# polynomial and its exponential branch, which a warp runs both of, the
# products and the bf16 rounding), the sizing of the MLP's GELU floor; the
# card issues one a lane a cycle, half its float32 FLOP rate (an FMA is 2)
GELU_INSTRUCTIONS = 25
FP32_INSTRUCTIONS_PER_S = PEAK_FLOPS["f32"] / 2


@contextlib.contextmanager
def strict_float32():
    """TF32 off in cuBLAS and cuDNN for the phases that hold a kernel
    against its plain version, or a model against its plain-routed self;
    the CLI's setting is restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


def device_rows(prof, reps: int) -> list:
    """[(kernel name, device ms per call, launches per call)] of a finished
    torch.profiler window over ``reps`` calls; empty where it recorded no
    device time."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((ev.key, us / reps / 1e3, ev.count / reps))
    return rows


def profiled(fn, reps: int, tries: int = 3):
    """Run ``fn`` ``reps`` times under torch.profiler; return (device rows,
    wall ms per call). CUPTI now and then hands back a window with no
    device time in it: such a window is taken again, up to ``tries`` times,
    and the rows stay empty if every window was."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        rows = device_rows(prof, reps)
        if rows:
            break
        print("torch.profiler window with no device time", flush=True)
    return rows, wall


def kernel_split(fn, reps: int = 3) -> list:
    """Each CUDA kernel's own time in one call of ``fn`` (torch.profiler
    over ``reps`` calls after a warm-up): [(name, ms per call, launches
    per call)], longest first; empty where the profiler recorded no device
    time (the kernels' times come from CUDA events all the same)."""
    fn()
    torch.cuda.synchronize()
    return sorted(profiled(fn, reps)[0], key=lambda r: -r[1])


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


def print_split(label: str, fn, part_bytes=None, split=None) -> dict:
    """Print each CUDA kernel's own time in one call of ``fn`` (or of the
    ``split`` kernel_split already took) and return the times summed by
    block part (``block_part``). ``part_bytes`` maps a kernel's name
    (``dwconv_ln_kernel``, ``dwcorr_kernel``, ``relu_grad_kernel``) to the
    bytes it must move: each such kernel is printed again beside its bytes
    bound and share, and the returned dict gets ``"bounds": {name: [ms,
    bound_ms]}``."""
    if split is None:
        split = kernel_split(fn)
    if not split:
        print(f"{label} split: not measured (torch.profiler recorded no "
              "device time in 3 windows)", flush=True)
        return {}
    parts = {}
    for kname, ms, _ in split:
        parts[block_part(kname)] = parts.get(block_part(kname), 0.0) + ms
    print(f"{label} split: " + "; ".join(
        f"{short_name(k)} {ms:.4f} ms x{n:g}" for k, ms, n in split),
        flush=True)
    if part_bytes:
        bounds = {}
        for key, nbytes in part_bytes.items():
            ms = sum(t for kname, t, _ in split if key in kname)
            bounds[key] = [ms, nbytes / HBM_BYTES_PER_S * 1e3]
        parts["bounds"] = bounds
        print(f"{label} parts against their bytes bounds: " + "; ".join(
            f"{key} {ms:.4f} ms, bound {b:.4f} ms, share {b / ms:.1%}"
            for key, (ms, b) in bounds.items() if ms > 0), flush=True)
    return parts


def depthwise_bytes(n: int, c: int, io: int, dx: bool) -> dict:
    """Bytes each depthwise pass of one block call must move, each input
    read once and each output written once (``io`` bytes an element of x,
    dy and dx): the forward's dwconv_ln reads x and writes u (bf16); the
    backward's also reads dy and writes xhat (f32) and gms (bf16); dwcorr
    reads dyconv (f32) and dy and writes dx. The taps (49 C f32) and
    vectors beside them."""
    taps = 49 * c * 4 + 5 * c * 4
    if not dx:
        return {"dwconv_ln_kernel": n * c * (io + 2) + taps}
    return {"dwconv_ln_kernel": n * c * (2 * io + 2 + 4 + 2) + n * 4 + taps,
            "dwcorr_kernel": n * c * (4 + 2 * io) + taps}


def block_fwd_bounds(n: int, c: int, io: int, p_io: int) -> dict:
    """The least time (``bound``: ms, what binds it) of each kernel of one
    block forward over n tokens of width c, x and out ``io`` bytes an
    element, the parameters ``p_io``: the packing (the parameters read,
    written packed: taps f32, W1 and W2 bf16, and bf16 vectors upcast to
    f32); dwconv_ln (depthwise_bytes; 49 FMAs an element); the fused MLP
    (u bf16, x and out, the bf16 weights; 16 n C^2 bf16 products) or its
    two GEMMs (mlp_gemm_kernel<0, ..>: u, W1, the bf16 hidden layer
    written; <1 or 5, ..>: it read, W2, x and out; 8 n C^2 each). Keys are
    the kernels' names up to their template arguments."""
    from robseg_torch.kernels import convnext_block as cb
    vec, w = 9 * c, 8 * c * c
    pack = (49 * c + w + vec) * p_io + 49 * c * 4 + 2 * w + (
        4 * vec if p_io == 2 else 0)
    out = {"pack_kernel": bound(pack, {"f32": 0.0}),
           "dwconv_ln_kernel": bound(
               depthwise_bytes(n, c, io, False)["dwconv_ln_kernel"],
               {"f32": 98 * n * c})}
    xo = 2 * io * n * c + 6 * c * 4
    if cb.fused(c):
        out["mlp_fused_kernel"] = bound(2 * n * c + 2 * w + xo,
                                        {"bf16": 16 * n * c * c})
    else:
        hid = 2 * n * 4 * c
        out["mlp_gemm_kernel<0"] = bound(2 * n * c + w + hid,
                                         {"bf16": 8 * n * c * c})
        out["mlp_gemm_kernel<" + ("5" if io == 2 else "1")] = bound(
            hid + w + xo, {"bf16": 8 * n * c * c})
    return out


def gelu_floor_ms(n: int, c: int) -> float:
    """The CUDA cores' least time for the MLP's n 4C exact GELUs at
    GELU_INSTRUCTIONS each."""
    return n * 4 * c * GELU_INSTRUCTIONS / FP32_INSTRUCTIONS_PER_S * 1e3


def print_fwd_parts(label: str, split, n: int, c: int, io: int, p_io: int,
                    call_ms: float) -> dict:
    """One block forward's device split (``split``, kernel_split's rows)
    by kernel: the packing, dwconv_ln and the MLP kernel or kernels, each
    beside its bound (block_fwd_bounds), the GELU's floor beside the
    kernel that runs the GELU, and the device sum beside the call's
    CUDA-event time. Returns {kernel: [ms, bound_ms]}."""
    if not split:
        print(f"{label} device split: not measured", flush=True)
        return {}
    bounds = block_fwd_bounds(n, c, io, p_io)
    parts, text = {}, []
    for kname, ms, _ in split:
        key = next((k for k in bounds if k in kname), None)
        if key is None:
            continue
        bms, by = bounds[key]
        parts[short_name(kname)] = [ms, bms]
        note = ""
        if "mlp_fused_kernel" in kname or "mlp_gemm_kernel<0" in kname:
            note = (f"; GELU floor {gelu_floor_ms(n, c):.4f} ms: "
                    f"{n * 4 * c / 1e6:.1f} M exact GELUs at "
                    f"{GELU_INSTRUCTIONS} float32 instructions")
        text.append(f"{short_name(kname)} {ms:.4f} ms (bound {bms:.4f} ms, "
                    f"{by}, share {bms / ms:.1%}{note})")
    device = sum(ms for ms, _ in parts.values())
    print(f"{label} device split: " + "; ".join(text) + f" | device sum "
          f"{device:.4f} ms, call {call_ms:.4f} ms", flush=True)
    return parts


def phase_kernels(dev, results, train_stages=()):
    from robseg_torch.kernels import apgd_step
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
    for shape in stages + [(2, 119, 119, 96)] + list(train_stages):
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
            parts = print_split(f"block {shape} {name}", fn,
                                depthwise_bytes(n, c, 4, name == "dx"),
                                split)
            if name == "fwd":
                print_fwd_parts(f"block {shape} fwd", split, n, c, 4, 4, tk)
            bms, bby = bound(*bb)
            print(f"block {shape} {name} by part {json.dumps(parts)} | bound "
                  f"{bms:.4f} ms ({bby}), roofline share {bms / tk:.1%}",
                  flush=True)
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

    phase_confusion(dev, results)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def fmt_share(bound_ms, ms) -> str:
    return "not measured" if ms is None else f"{bound_ms / ms:.1%}"


def label_maps(shape, k, blocky, dev, seed):
    """(pred, target) int64 label maps on the card: independent random
    classes, or piecewise-constant 32 x 32 regions (as in real label maps,
    where neighbouring pixels share a (target, pred) bin); pred equals
    target on about half of the pixels (regions), and 5% of the pixels
    (regions) are ignored (-1 in both, as SEA masks its predictions)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w = shape

    def draw(hi):
        if not blocky:
            return torch.randint(0, hi, shape, device=dev, generator=g)
        small = torch.randint(0, hi, (b, h // 32 + 1, w // 32 + 1),
                              device=dev, generator=g)
        return small.repeat_interleave(32, 1).repeat_interleave(
            32, 2)[:, :h, :w].contiguous()
    tgt = draw(k)
    pred = torch.where(draw(2) == 0, tgt, draw(k))
    ign = draw(20) == 0
    return pred.masked_fill(ign, -1), tgt.masked_fill(ign, -1)


# the confusion phase's class counts, each with whether the shared form's
# first design (one K x K histogram in shared memory, K <= 238) runs beside
# the kernel: VOC's 21 and ADE20K's 151 (the shared form), and in the global
# form the first K past it, 300, PASCAL-Context's 459, ADE20K-full's 847
# (per image, its 16 outputs pass 5/8 of an H100's L2: half the images at
# once) and 673 (0.55 of that L2: all the images at once)
CONFUSION_CASES = ((N_CLS, True), (N_ADE, True), (239, False), (300, False),
                   (459, False), (847, False), (673, False))


def phase_confusion(dev, results):
    """The confusion kernel against its plain version, bit for bit, at the
    SEA batch (16 x 512^2): each K of ``CONFUSION_CASES``, random and
    blocky labels, summed and per image; the form ``plan`` chose and its
    grid, checked against the kernel the profiler saw; times of the
    kernel, of the first design where it runs
    (``confusion_matrix_v1_cuda``), of the plain version and of one
    torch.bincount of the precomputed bin index, and the bytes bound. Then the metrics that call the kernel at K = 847 on
    the card against the same calls on the CPU."""
    from robseg_torch.kernels import confusion as cf
    cases = []
    launches0 = cf.confusion_matrix_cuda.launches
    card = cf.card(dev.index if dev.index is not None else 0)
    print(f"confusion plan's card: {card[0]} SMs, {card[1]} bytes of L2",
          flush=True)
    for seed, (k, blocky, with_v1) in enumerate(
            (k, blocky, v1) for k, v1 in CONFUSION_CASES
            for blocky in (False, True)):
        pred, tgt = label_maps((BATCH, HW, HW), k, blocky, dev, seed)
        for per_image in (False, True):
            kw = dict(num_classes=k, per_image=per_image)
            launch = cf.plan(k, BATCH if per_image else 1,
                             HW * HW * (1 if per_image else BATCH), *card)
            form = launch["form"]
            want = cf.confusion_matrix_plain(pred, tgt, **kw)
            got = cf.confusion_matrix_cuda(pred, tgt, **kw)
            old = cf.confusion_matrix_v1_cuda(pred, tgt, **kw) if with_v1 \
                else want
            # the library yardstick: one torch.bincount of the precomputed
            # (image,) t * K + p index of the counted pixels
            img = torch.arange(BATCH, device=dev).view(BATCH, 1, 1)
            idx = (tgt * k + pred + (img * k * k if per_image else 0))[
                tgt != -1]
            n_bins = want.numel()
            lib = torch.bincount(idx, minlength=n_bins)
            if not (torch.equal(got, want) and torch.equal(old, want)
                    and torch.equal(lib.view(want.shape).float(), want)):
                raise AssertionError(f"confusion K={k} blocky={blocky} "
                                     f"per_image={per_image}: kernel, first "
                                     "design or bincount differs from plain")
            new = lambda: cf.confusion_matrix_cuda(pred, tgt, **kw)  # noqa
            v1 = lambda: cf.confusion_matrix_v1_cuda(pred, tgt, **kw)  # noqa
            t = [cuda_ms(new), cuda_ms(v1) if with_v1 else None,
                 cuda_ms(lambda: cf.confusion_matrix_plain(pred, tgt, **kw)),
                 cuda_ms(lambda: torch.bincount(idx, minlength=n_bins))]
            # each histogram kernel's own device time with the memset that
            # zeroes its output (torch.profiler): the CUDA-event times above
            # include the wrapper's host work
            dt, mem, names = confusion_device_ms(new)
            ran = ("not seen (no device time)" if not names
                   else "seen" if CONFUSION_KERNEL[form] in names
                   else None)
            if ran is None:
                raise AssertionError(f"confusion K={k} per_image={per_image}:"
                                     f" plan chose the {form} form "
                                     f"({CONFUSION_KERNEL[form]}), the card "
                                     f"ran {sorted(names)}")
            dt = [dt, confusion_device_ms(v1)[0] if with_v1 else None]
            # pred and target int64 in, the float32 histogram out
            bms, bby = bound(16 * tgt.numel() + 4 * n_bins, {"f32": 0})
            labels = "blocky" if blocky else "random"
            first = (f"first design {t[1]:.4f} ms (device {fmt_ms(dt[1])})"
                     if with_v1 else "first design not run (K > 238)")
            print(f"confusion_matrix (16,512,512) K={k} {labels} per_image="
                  f"{per_image} ({form} form, grid {launch['grid']}, "
                  f"{CONFUSION_KERNEL[form]} {ran}): exact (kernel"
                  f"{', first design' if with_v1 else ''}, bincount), "
                  f"kernel {t[0]:.4f} ms (device {fmt_ms(dt[0])}, memset "
                  f"{fmt_ms(mem)} of it), {first}, "
                  f"plain {t[2]:.3f} ms, library (torch.bincount) "
                  f"{t[3]:.4f} ms, bound {bms:.4f} ms ({bby}), share "
                  f"{bms / t[0]:.1%} (device {fmt_share(bms, dt[0])})",
                  flush=True)
            cases.append({"k": k, "labels": labels, "per_image": per_image,
                          "form": form, "grid": launch["grid"], "ms": t[0],
                          "device_ms": dt[0], "memset_ms": mem, "v1_ms": t[1],
                          "v1_device_ms": dt[1], "plain_ms": t[2],
                          "library_ms": t[3], "bound_ms": bms,
                          "bound_by": bby, "share": bms / t[0]})
        del pred, tgt, idx
    forms = {f: sum(c["form"] == f for c in cases) for f in cf.FORMS}
    print(f"confusion phase: {cf.confusion_matrix_cuda.launches - launches0} "
          f"kernel launches, cases by form {forms} of {len(cases)}",
          flush=True)
    confusion_callers_check(dev, 847)
    head = cases[0]  # K = 21, random labels, summed: the row's numbers
    results["confusion_matrix"] = {
        "max_abs_err": 0.0, "cases": cases,
        **{key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}}


# the kernel each form of the confusion kernel launches (csrc/confusion.cu)
CONFUSION_KERNEL = {"shared": "confusion_kernel",
                    "global": "confusion_global_kernel"}


def confusion_device_ms(fn):
    """The device ms of one call of ``fn`` (torch.profiler): (the confusion
    kernels and the memset that zeroes their output, the memset's part, the
    set of the confusion kernels' names without template arguments), or
    (None, None, empty) where the profiler recorded no device time."""
    split = kernel_split(fn)
    mem = sum(ms for name, ms, _ in split if "emset" in name)
    kern = sum(ms for name, ms, _ in split if "confusion" in name)
    names = {short_name(name).split("<")[0] for name, _, _ in split
             if "confusion" in name}
    return (kern + mem, mem, names) if kern else (None, None, set())


def confusion_callers_check(dev, k):
    """``iou_acc_summary`` and ``per_image_intersect_union`` on the card
    (the kernel's global form at K = 847) against the same calls on CPU
    copies (the plain version): histograms, intersections and unions bit
    for bit; the (mAcc, aAcc, mIoU) triple to 1e-6, the float32 means of
    847 classes being summed in another order on the card."""
    from robseg_torch.ops.metrics import (confusion_matrix, iou_acc_summary,
                                          per_image_intersect_union)
    pred, tgt = label_maps((BATCH, HW, HW), k, True, dev, 100)
    cpu = (pred.cpu(), tgt.cpu())
    kw = dict(num_classes=k, ignore_label=-1)
    if not torch.equal(confusion_matrix(pred, tgt, **kw).cpu(),
                       confusion_matrix(*cpu, **kw)):
        raise AssertionError(f"confusion_matrix K={k}: card != CPU")
    for got, want in zip(per_image_intersect_union(pred, tgt, **kw),
                         per_image_intersect_union(*cpu, **kw)):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"per_image_intersect_union K={k}: card "
                                 "!= CPU")
    got = torch.stack(iou_acc_summary(pred, tgt, **kw)).cpu()
    want = torch.stack(iou_acc_summary(*cpu, **kw))
    err = float((got - want).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"iou_acc_summary K={k}: card {got.tolist()} "
                             f"against CPU {want.tolist()}")
    print(f"metrics K={k} (16,512,512) on the card against the CPU: "
          "confusion_matrix and per_image_intersect_union exact, "
          f"iou_acc_summary (mAcc, aAcc, mIoU) {got.tolist()} max abs diff "
          f"{err:.3g}", flush=True)


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
            print_split(f"fpn_concat_conv {n}x{shape} fwd",
                        lambda: fc.fpn_concat_conv_fwd_cuda(xs, w, s, t))
            # relu_grad reads dy and out (f32) and s, writes g (bf16)
            print_split(f"fpn_concat_conv {n}x{shape} dx",
                        lambda: fc.fpn_concat_conv_dx_cuda(dy, out, w, s),
                        {"relu_grad_kernel": m * co * (4 + 4 + 2) + 4 * co})
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


def bf16_forms(form_bf16, form_f32, *args):
    """A bf16 I/O kernel form on bf16 operands, and its float32 form on the
    same values upcast with the result rounded once to bf16 (each a
    tensor, or a tuple of them)."""
    def up(a):
        if isinstance(a, (list, tuple)):
            return [up(t) for t in a]
        return a.float() if a.dtype == torch.bfloat16 else a

    def down(r):
        return tuple(down(t) for t in r) if isinstance(r, tuple) else \
            r.to(torch.bfloat16)
    return form_bf16(*args), down(form_f32(*up(list(args))))


def n_differ(got, want) -> int:
    """Elements of ``got`` not bit for bit equal to ``want``."""
    if isinstance(got, tuple):
        return sum(n_differ(a, b) for a, b in zip(got, want))
    return int((got.view(torch.int16) != want.view(torch.int16)).sum())


def phase_bf16_kernels(dev, results):
    """The bf16 I/O forms of the block pair (the four stages, and the
    ragged VOC stage 1) and of the FPN pair (the head's shape): bit for bit
    their float32 forms on the upcast inputs rounded once, then against
    the plain versions on the same bf16 inputs, with times and bounds."""
    import torch.nn.functional as F
    from robseg_torch.kernels import convnext_block as cb
    from robseg_torch.kernels import fpn_conv as fc
    bf16 = torch.bfloat16
    rng = np.random.default_rng(4)
    rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": None, "stages": []}
            for k in ("convnext_block_fwd_bf16", "convnext_block_dx_bf16")}
    fwd, dxr = rows.values()
    stages = [(BATCH, 128, 128, 96), (BATCH, 64, 64, 192),
              (BATCH, 32, 32, 384), (BATCH, 16, 16, 768)]
    dw_sum = {"dwconv_ln_kernel": [0.0, 0.0], "dwcorr_kernel": [0.0, 0.0]}
    for shape in stages + [(2, 119, 119, 96)]:
        p = [t.to(bf16) for t in block_params(rng, shape[-1], dev)]
        x = torch.randn(shape, device=dev).to(bf16)
        dy = torch.randn(shape, device=dev).to(bf16)
        out, out32 = bf16_forms(cb.convnext_block_fwd_bf16_cuda,
                                cb.convnext_block_fwd_cuda, x, *p)
        dx, dx32 = bf16_forms(cb.convnext_block_dx_bf16_cuda,
                              cb.convnext_block_dx_cuda, x, dy, *p)
        want = cb.convnext_block_plain(x, *p).float()
        dx_want = cb.convnext_block_dx_plain(x, dy, *p).float()
        torch.cuda.synchronize()
        diff = (n_differ(out, out32), n_differ(dx, dx32))
        e_fwd = float((out.float() - want).abs().max())
        e_dx = rel_max_err(dx.float(), dx_want)
        ok = (out.dtype == dx.dtype == bf16 and diff == (0, 0)
              and bool(torch.isclose(out.float(), want, atol=2e-2,
                                     rtol=2e-2).all()) and e_dx <= 2e-2)
        t = [cuda_ms(lambda: cb.convnext_block_fwd_bf16_cuda(x, *p)),
             cuda_ms(lambda: cb.convnext_block_plain(x, *p)),
             cuda_ms(lambda: cb.convnext_block_dx_bf16_cuda(x, dy, *p)),
             cuda_ms(lambda: cb.convnext_block_dx_plain(x, dy, *p))]
        # bf16 x in and out (dx: x, dy in, dx out), the bf16 weights; the
        # operations of the float32 form
        n, c = x.numel() // shape[-1], shape[-1]
        fb = (4 * n * c + 16 * c * c, {"bf16": 16 * n * c * c,
                                       "f32": 98 * n * c})
        db = (6 * n * c + 16 * c * c, {"bf16": 24 * n * c * c,
                                       "f32": 196 * n * c})
        bf_, bd = bound(*fb), bound(*db)
        print(f"block bf16 I/O {shape}: elements differing from the float32 "
              f"kernel on the upcast inputs, rounded once: fwd {diff[0]}, dx "
              f"{diff[1]} | vs plain: fwd max_abs_err {e_fwd:.3e}, dx "
              f"rel_max_err {e_dx:.3e} | fwd kernel {t[0]:.3f} ms, plain "
              f"{t[1]:.3f} ms, bound {bf_[0]:.4f} ms ({bf_[1]}), share "
              f"{bf_[0] / t[0]:.1%} | dx kernel {t[2]:.3f} ms, plain "
              f"{t[3]:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}), share "
              f"{bd[0] / t[2]:.1%}", flush=True)
        if not ok:
            raise AssertionError(f"block bf16 {shape}: differing {diff}, "
                                 f"fwd {e_fwd}, dx {e_dx}")
        fwd["max_abs_err"] = max(fwd["max_abs_err"], e_fwd)
        dxr["max_abs_err"] = max(dxr["max_abs_err"],
                                 float((dx.float() - dx_want).abs().max()))
        for row, name, fn, tk, tp, bb in (
                (fwd, "fwd", lambda: cb.convnext_block_fwd_bf16_cuda(x, *p),
                 t[0], t[1], fb),
                (dxr, "dx", lambda: cb.convnext_block_dx_bf16_cuda(x, dy, *p),
                 t[2], t[3], db)):
            split = kernel_split(fn)
            parts = print_split(f"block bf16 I/O {shape} {name}", fn,
                                depthwise_bytes(n, c, 2, name == "dx"),
                                split)
            if name == "fwd":
                print_fwd_parts(f"block bf16 I/O {shape} fwd", split, n, c,
                                2, 2, tk)
            bms, bby = bound(*bb)
            if name == "dx" and shape in stages:
                for key, (ms, b) in parts.get("bounds", {}).items():
                    dw_sum[key] = [a + v for a, v in zip(dw_sum[key],
                                                         (ms, b))]
            row["stages"].append({"shape": list(shape), "ms": tk,
                                  "plain_ms": tp, "bound_ms": bms,
                                  "bound_by": bby, "share": bms / tk,
                                  "parts_ms": parts})
            if shape in stages:
                row["ms"] += tk
                row["plain_ms"] += tp
                add_bound(row, *bb)
        del x, dy, out, out32, dx, dx32, want, dx_want
    results.update(rows)
    ms, b = (sum(v[i] for v in dw_sum.values()) for i in (0, 1))
    print("block bf16 I/O dx, the depthwise passes of the four batch-16 "
          "stages summed: " + " + ".join(
              f"{key} {v[0]:.4f} ms (bound {v[1]:.4f}, share "
              f"{fmt_share(v[1], v[0] or None)})"
              for key, v in dw_sum.items())
          + f" = {ms:.4f} ms, bytes bound {b:.4f} ms, share "
          f"{fmt_share(b, ms or None)}", flush=True)

    n, shape, co = 4, (BATCH, 128, 128, 512), 512
    c = shape[-1]
    xs = [torch.randn(shape, device=dev).to(bf16) for _ in range(n)]
    w = torch.tensor(rng.normal(size=(n, 3, 3, c, co)) / 70,
                     device=dev).to(bf16)
    s = torch.tensor(1 + 0.1 * rng.normal(size=co), dtype=torch.float32,
                     device=dev)
    t = torch.tensor(0.1 * rng.normal(size=co), dtype=torch.float32,
                     device=dev)
    out, out32 = bf16_forms(fc.fpn_concat_conv_fwd_bf16_cuda,
                            fc.fpn_concat_conv_fwd_cuda, xs, w, s, t)
    dy = torch.randn(out.shape, device=dev).to(bf16)
    dx, dx32 = bf16_forms(fc.fpn_concat_conv_dx_bf16_cuda,
                          fc.fpn_concat_conv_dx_cuda, dy, out, w, s)
    torch.cuda.synchronize()
    diff = (n_differ(out, out32), n_differ(dx, dx32))
    del out32, dx32
    want = fc.fpn_concat_conv_fwd_plain(xs, w, s, t).float()
    dx_want = [d.float() for d in fc.fpn_concat_conv_dx_plain(dy, out, w, s)]
    torch.cuda.synchronize()
    # the float32 forms' bounds against plain (max abs 1e-3 forward, 2e-3
    # of the largest entry for the gradients) plus one bf16 step
    e_fwd = float((out.float() - want).abs().max())
    e_dx = max(rel_max_err(a.float(), b) for a, b in zip(dx, dx_want))
    ok = (out.dtype == bf16 and all(d.dtype == bf16 for d in dx)
          and diff == (0, 0)
          and bool(torch.isclose(out.float(), want, atol=1e-3,
                                 rtol=2 ** -7).all())
          and all(bool(torch.isclose(a.float(), b, rtol=2 ** -7,
                                     atol=2e-3 * float(b.abs().max())).all())
                  for a, b in zip(dx, dx_want)))
    t_k = [cuda_ms(lambda: fc.fpn_concat_conv_fwd_bf16_cuda(xs, w, s, t)),
           cuda_ms(lambda: fc.fpn_concat_conv_fwd_plain(xs, w, s, t)),
           cuda_ms(lambda: fc.fpn_concat_conv_dx_bf16_cuda(dy, out, w, s)),
           cuda_ms(lambda: fc.fpn_concat_conv_dx_plain(dy, out, w, s))]
    # the library yardsticks of phase 2: one bf16 cuDNN call
    xcat = torch.cat(xs, -1).permute(0, 3, 1, 2)
    wbf = fc._full_weight(w).contiguous(memory_format=torch.channels_last)
    gbf = dy.permute(0, 3, 1, 2)
    lib = [cuda_ms(lambda: F.conv2d(xcat, wbf, padding=1)),
           cuda_ms(lambda: F.conv_transpose2d(gbf, wbf, padding=1))]
    del xcat
    m = out.numel() // co
    flops = {"bf16": 2 * m * co * n * 9 * c}
    fb = (2 * n * m * c + 2 * m * co + 2 * w.numel(), flops)
    db = (2 * 2 * m * co + 2 * n * m * c + 2 * w.numel(), flops)
    bf_, bd = bound(*fb), bound(*db)
    print(f"fpn_concat_conv bf16 I/O {n}x{shape} Co={co}: elements differing "
          f"from the float32 kernel on the upcast inputs, rounded once: fwd "
          f"{diff[0]}, dx {diff[1]} | vs plain: fwd max_abs_err {e_fwd:.3e} "
          f"(max|out| {float(want.abs().max()):.3e}), dx rel_max_err "
          f"{e_dx:.3e} | fwd kernel {t_k[0]:.3f} ms, plain {t_k[1]:.3f} ms, "
          f"library {lib[0]:.3f} ms, bound {bf_[0]:.3f} ms ({bf_[1]}), share "
          f"{bf_[0] / t_k[0]:.1%} | dx kernel {t_k[2]:.3f} ms, plain "
          f"{t_k[3]:.3f} ms, library {lib[1]:.3f} ms, bound {bd[0]:.3f} ms "
          f"({bd[1]}), share {bd[0] / t_k[2]:.1%}", flush=True)
    if not ok:
        raise AssertionError(f"fpn bf16: differing {diff}, fwd {e_fwd}, dx "
                             f"{e_dx}")
    print_split(f"fpn_concat_conv bf16 I/O {n}x{shape} fwd",
                lambda: fc.fpn_concat_conv_fwd_bf16_cuda(xs, w, s, t))
    # relu_grad reads dy and out (bf16) and s, writes g (bf16)
    print_split(f"fpn_concat_conv bf16 I/O {n}x{shape} dx",
                lambda: fc.fpn_concat_conv_dx_bf16_cuda(dy, out, w, s),
                {"relu_grad_kernel": m * co * (2 + 2 + 2) + 4 * co})
    for name, tk, tp, tl, bb, err in (
            ("fpn_concat_conv_fwd_bf16", t_k[0], t_k[1], lib[0], fb, e_fwd),
            ("fpn_concat_conv_dx_bf16", t_k[2], t_k[3], lib[1], db,
             max(float((a.float() - b).abs().max())
                 for a, b in zip(dx, dx_want)))):
        results[name] = {"max_abs_err": err, "ms": tk, "plain_ms": tp,
                         "library_ms": tl}
        add_bound(results[name], *bb)


def build_model(dev):
    from robseg_torch.models import ModelBundle, build_model as build
    torch.manual_seed(0)
    module = build("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST",
                   N_CLS)
    return ModelBundle(module.to(dev))


def fused_model(dev, weights, precision="default", **settings):
    """The model in other fused settings (or, with no settings, the main
    path's), with the main path's weights, at ``precision``."""
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    module = UperNetForSemanticSegmentation("T_CVST", N_CLS, **settings)
    module.load_state_dict(weights, strict=True)
    return ModelBundle(module.to(dev), precision).logits_fn


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


def phase_model(dev, logits_fn, label="model", atol=2e-2):
    """A model against itself with every kernel routed to its plain
    version: logits within ``atol`` (and rtol), float32; the input
    gradient within 0.15 of its largest entry with cosine >= 0.99."""
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
    print(f"{label} (2,3,512,512): logits max_abs_err {e_l:.3e} (max|logit| "
          f"{float(lp.abs().max()):.3e}), argmax agreement "
          f"{float((lk.argmax(1) == lp.argmax(1)).float().mean()):.5f}, "
          f"mask-ce-avg pixels {int(pick.sum())}, input-grad rel_max_err "
          f"{e_g:.3e}, cosine {cos:.6f}", flush=True)
    if lk.dtype != torch.float32:
        raise AssertionError(f"{label}: logits are {lk.dtype}")
    torch.testing.assert_close(lk, lp, atol=atol, rtol=atol)
    # through all 18 blocks the bf16 rounding of each block's matmul
    # operands compounds; the bound is the JAX package's own for a model
    # run through its block kernel (tests/test_kernels.py:313-316)
    if not (math.isfinite(e_g) and e_g <= 0.15 and cos >= 0.99):
        raise AssertionError(f"{label} input grad: rel max err {e_g}, "
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


def phase_apgd(dev, logits_fn, n_iter=20, label="main path", hw=HW,
               n_cls=N_CLS) -> dict:
    """bench.py's protocol at batch 16: whole-run and marginal
    step*imgs/s of APGD (mask-ce-avg tracking ce-avg, random start) from
    2 timed runs each of ``n_iter`` and 4 iterations (2, not 3, to keep
    the whole script near 10 minutes), and the peak memory."""
    from robseg_torch.attacks.apgd import apgd_attack
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((BATCH, 3, hw, hw), device=dev, generator=g)
    y = torch.randint(0, n_cls, (BATCH, hw, hw), device=dev, generator=g)

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
    reps = 2
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
    print(f"apgd {label} ({BATCH},3,{hw},{hw}) mask-ce-avg/ce-avg rs: "
          f"whole-run {whole:.2f} step*imgs/s, marginal "
          f"{BATCH / per_iter:.2f} step*imgs/s ({per_iter * 1e3:.1f} "
          f"ms/iteration), {n_iter}-iter run {(t2 - t1) / reps:.2f} s, peak "
          f"memory {peak / 2**30:.2f} GiB, final mean acc "
          f"{float(res.acc.mean()):.4f}", flush=True)
    return {"whole": whole, "marginal": BATCH / per_iter,
            "ms_per_iteration": per_iter * 1e3, "peak_gib": peak / 2**30}


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
    # cuBLAS's Hopper GEMMs are also named nvjet_...
    if "gemm" in low or "cutlass" in low or "nvjet" in low:
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
    rows, wall = profiled(step, reps)
    if not rows:
        print(f"{label} profile, one forward + input gradient at batch 16: "
              f"{wall:.1f} ms wall; kernel time by kind not measured "
              "(torch.profiler recorded no device time in 3 windows)",
              flush=True)
        return
    kinds, top = {}, []
    for key, ms, count in rows:
        kind = kernel_kind(key, tail)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        top.append((ms, short_name(key), round(count)))
    busy = sum(kinds.values())
    print(f"{label} profile, one forward + input gradient at batch 16: "
          f"{wall:.1f} ms wall, {busy:.1f} ms of kernels, idle share "
          f"{max(0.0, 1 - busy / wall):.4f}; by kind: " + "; ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"{label} profile, top kernels: " + "; ".join(
        f"{n} {ms:.2f} ms x{c}" for ms, n, c in sorted(top, reverse=True)[
            :12]), flush=True)


def fixture_voc(tmp: str) -> str:
    """The 8-image fixture VOC tree of tools/make_fixture_dataset.py."""
    root = os.path.join(tmp, "voc")
    if not os.path.isdir(root):
        subprocess.run([sys.executable, os.path.join(
            REPO, "tools", "make_fixture_dataset.py"), "--root", root,
            "--n_train", "0", "--n_val", "8"], check=True)
    return root


def fixture_ade(tmp: str) -> str:
    """An 8-image ADE20K-layout tree (ADEChallengeData2016/images/
    validation/*.jpg and annotations/validation/*.png), 640 x 512 random
    images over piecewise-constant labels 0..150."""
    from PIL import Image
    root = os.path.join(tmp, "ade")
    base = os.path.join(root, "ADEChallengeData2016")
    img_dir = os.path.join(base, "images", "validation")
    ann_dir = os.path.join(base, "annotations", "validation")
    if os.path.isdir(img_dir):
        return root
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    for i in range(8):
        rng = np.random.default_rng(100 + i)
        small = rng.integers(0, N_ADE, (8, 10)).astype(np.uint8)
        lab = np.kron(small, np.ones((64, 64), np.uint8))[:512, :640]
        img = (rng.random((512, 640, 3)) * 128 + (lab[..., None] % 64) * 2)
        stem = f"ADE_val_{i:08d}"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, stem + ".jpg"))
        Image.fromarray(lab).save(os.path.join(ann_dir, stem + ".png"))
    return root


def cli_save_dir(tmp: str, cfg_name: str = "rig_voc_demo.yaml",
                 precision: str = "default", label: str = "") -> str:
    """The SAVE_DIR of ``phase_cli``'s run with these arguments."""
    return os.path.join(tmp, f"out_{os.path.splitext(cfg_name)[0]}_"
                             f"{precision}{label}")


def phase_cli(tmp: str, precision: str = "default",
              cfg_name: str = "rig_voc_demo.yaml", fixture=fixture_voc,
              eps=(8,), n_iter: int = 10, ckpt=None, launch=(), flags=(),
              env=None, label: str = "") -> tuple:
    """The SEA CLI (``python -m robseg_torch.infer``) on a fixture tree
    with a config from configs/ (its ROOT and SAVE_DIR pointed into
    ``tmp``), one batch, every eps of ``eps``, on the weights of ``ckpt``
    (random init without): one finite JSON a eps whose worst case is at
    most each loss's mIoU, and every adversarial batch inside its eps
    ball. ``launch``: the launcher's arguments between the interpreter and
    ``-m`` (torchrun's, for ``--shard``); ``flags``: more CLI flags;
    ``env``: more environment. Returns the kernel launch counts it
    printed and the JSONs."""
    import yaml
    root = fixture(tmp)
    with open(os.path.join(REPO, "configs", cfg_name)) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"]["ROOT"] = root
    cfg["SAVE_DIR"] = cli_save_dir(tmp, cfg_name, precision, label)
    cfg_path = os.path.join(tmp, f"cfg_{os.path.basename(cfg['SAVE_DIR'])}"
                            ".yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.time()
    p = subprocess.run([sys.executable, *launch, "-m", "robseg_torch.infer",
                        "--cfg", cfg_path,
                        "--eps", ",".join(f"{e:g}" for e in eps),
                        "--n_iter", str(n_iter), "--n_batches", "1",
                        "--precision", precision, *flags]
                       + (["--ckpt", ckpt] if ckpt else []),
                       cwd=REPO, capture_output=True, text=True,
                       env=None if env is None else {**os.environ, **env})
    if p.returncode != 0:
        raise RuntimeError(f"SEA CLI exited {p.returncode}:\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    out = p.stdout
    outs = sorted(f for f in os.listdir(cfg["SAVE_DIR"])
                  if f.startswith("worse_SEA_") and f.endswith(".json"))
    if len(outs) != len(eps):
        raise AssertionError(f"expected {len(eps)} worse_SEA_*.json, got "
                             f"{outs}")

    def numbers(v):
        if isinstance(v, dict):
            return [n for u in v.values() for n in numbers(u)]
        if isinstance(v, list):
            return [n for u in v for n in numbers(u)]
        return [float(v)]
    results = []
    for name in outs:
        with open(os.path.join(cfg["SAVE_DIR"], name)) as f:
            res = json.load(f)
        if not all(math.isfinite(n) for n in numbers(res)):
            raise AssertionError(f"non-finite number in {name}")
        if res["final_miou"] > min(res["loss-wise_miou"]) + 1e-6:
            raise AssertionError(f"{name}: final_miou above a loss-wise mIoU")
        results.append(res)
    checks = re.findall(r"batch \d+: max Linf pert: ([0-9.e+-]+), nan in "
                        r"imgs: (\d+), max in imgs: ([0-9.e+-]+), min in "
                        r"imgs: ([0-9.e+-]+)", out)
    if len(checks) != 3 * len(eps):
        raise AssertionError(f"expected {3 * len(eps)} check_imgs lines, got "
                             f"{checks}")
    for i, (pert, nan, hi, lo) in enumerate(checks):
        # three losses a eps, in the sweep's order; printed with 5 decimals
        if not (float(pert) <= eps[i // 3] / 255 + 1e-5 and int(nan) == 0
                and float(hi) <= 1.0 and float(lo) >= 0.0):
            raise AssertionError(f"adversarial images out of bounds at eps "
                                 f"{eps[i // 3]}/255: {pert} {nan} {hi} "
                                 f"{lo}")
    m = re.search(r"^kernel launches: (\{.*\})$", out, re.M)
    if m is None:
        raise AssertionError("SEA CLI printed no kernel launch counts")
    counts = json.loads(m.group(1))
    if ckpt and "evaluating random init" in out:
        raise AssertionError(f"SEA CLI did not load {ckpt}")
    print(f"SEA CLI {cfg_name} --precision {precision} "
          + "".join(f"{a} " for a in (*launch, *flags)) + "(8 fixture images, "
          f"one batch, n_iter {n_iter}, eps {list(eps)}/255) in "
          f"{time.time() - t0:.1f} s: " + "; ".join(
              f"eps {e:g}: clean {r['clean']}, worst_Acc {r['worst_Acc']:.4f}"
              f", final_miou {r['final_miou']:.4f}, loss-wise mIoU "
              f"{r['loss-wise_miou']}" for e, r in zip(eps, results))
          + f"; max Linf pert {max(float(c[0]) for c in checks):.5f}; "
          f"launches {counts}", flush=True)
    return counts, results


def phase_bench_fused(modes=("rs", "recompute_bf16", "head"),
                      flags=()) -> dict:
    """The fused-variant entry point as a user runs it; returns its kernel
    launch counts."""
    modes = list(modes)
    t0 = time.time()
    args = ["--modes", ",".join(modes), "--batch", "4", "--n_iter", "3",
            *flags]
    p = subprocess.run([sys.executable, "-m", "robseg_torch.bench_fused",
                        *args], cwd=REPO, capture_output=True, text=True)
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
    print(f"bench_fused ({' '.join(args)}) in {time.time() - t0:.1f} s: "
          f"{json.dumps(res)}; launches {counts}", flush=True)
    return counts


def phase_probe(dev, tmp, fns):
    """How far the numerics move the attacked metrics (tools/bench_bf16.py's
    protocol): apgd_largereps with mask-ce-avg (early stop, tracking
    ce-avg, random start) on one fixed batch of 8 fixture VOC images at
    512^2, eps 0.5/255, 4/255 and 8/255, for each mode of ``fns`` (name ->
    (logits function, numerics scope)); the default model, under the
    default numerics, scores every mode's adversarial examples."""
    from robseg_torch.attacks.apgd import apgd_largereps
    from robseg_torch.data import get_segmentation_dataset, simple_eval_loader
    from robseg_torch.ops.metrics import (confusion_matrix, iou_from_hist,
                                          pixel_acc_from_hist)
    ds = get_segmentation_dataset("pascalvoc", root=fixture_voc(tmp),
                                  split="val", crop_size=HW)
    xn, yn = next(simple_eval_loader(ds, 8, 1))
    x = torch.tensor(xn, device=dev)
    y = torch.tensor(yn, device=dev)
    score_fn = fns["default"][0]

    def metrics(x_adv):
        with torch.no_grad():
            pred = score_fn(x_adv).argmax(1)
        hist = confusion_matrix(pred, y, num_classes=N_CLS, ignore_label=-1)
        return (float(pixel_acc_from_hist(hist)[2]),
                float(iou_from_hist(hist)[1]))

    out = {}
    t0 = time.time()
    # 4 and 8 are the protocol's; a random-init model falls to ~0 accuracy
    # at both, so 0.5 is added, the sub-saturating eps tools/bench_bf16.py
    # names for weak models
    for eps in (0.5, 4, 8):
        for name, (fn, scope) in fns.items():
            with scope():
                adv, _, acc = apgd_largereps(
                    fn, x, y, weights=None, norm="Linf", eps=eps / 255,
                    n_iter=PROBE_ITERS, loss="mask-ce-avg", early_stop=True,
                    track_loss="ce-avg", use_rs=True,
                    generator=torch.Generator(dev).manual_seed(1))
            if float((adv - x).abs().max()) > eps / 255 + 1e-6:
                raise AssertionError(f"probe {name}: outside the eps ball")
            aacc, miou = metrics(adv)
            out[f"eps{eps:g}_{name}_rob_aAcc"] = aacc
            out[f"eps{eps:g}_{name}_rob_mIoU"] = miou
            out[f"eps{eps:g}_{name}_mean_acc"] = float(acc.mean())
        for a, b in (("bf16", "default"), ("default", "strict")):
            for k in ("aAcc", "mIoU"):
                pre = f"eps{eps:g}_"
                out[f"{pre}{a}_vs_{b}_delta_{k}"] = (
                    out[f"{pre}{a}_rob_{k}"] - out[f"{pre}{b}_rob_{k}"])
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"probe: {out}")
    print(f"attacked-metric probe (apgd_largereps mask-ce-avg, n_iter "
          f"{PROBE_ITERS}, 8 fixture images at 512^2, random init) in "
          f"{time.time() - t0:.1f} s: {json.dumps(out)}", flush=True)


def family_module(name: str, backbone: str, n_cls: int, crop: int):
    """A model of the Segmenter or PSPNet/DeepLab families at full width
    with seeded random weights, as the CLI builds it for a ``crop`` x
    ``crop`` config (the crop is the Segmenter's native grid)."""
    from robseg_torch.models import build_model as build
    torch.manual_seed(0)
    return build(name, backbone, n_cls, image_size=(crop, crop))


# (model, backbone, classes, config crop, checked input side): each family
# at full width; the ResNet models on 257^2 and the Segmenter on 473^2 (the
# pad path and the position embedding's resize), so each CPU reference
# takes seconds
CPU_CHECKS = (("SegMenter", "vit_small_patch16_224", N_ADE, 512, 473),
              ("PSPNet", "ResNet-50", N_CLS, 473, 257),
              ("PSPNet_DDCAT", "ResNet-50", N_CLS, 473, 257),
              ("DeepLabV3", "ResNet-50", N_CLS, 473, 257),
              ("DeepLabV3_DDCAT", "ResNet-50", N_CLS, 473, 257))


def mask_ce_run(fn, x, y):
    """(logits, input gradient of sum(mask-ce-avg)) of a logits function."""
    from robseg_torch.ops.losses import ATTACK_CRITERIA
    xg = x.clone().requires_grad_(True)
    logits = fn(xg)
    loss = ATTACK_CRITERIA["mask-ce-avg"](logits, y).sum()
    return logits.detach(), torch.autograd.grad(loss, xg)[0]


def cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))


def phase_family_vs_cpu(dev):
    """(TF32 off) Each new family's model at full width, batch 1: logits
    and the input gradient of sum(mask-ce-avg) on the card against the
    same module on the CPU, the largest error as a share of the largest
    entry, in float32 and in float64.

    Gates: float32 logits <= 1e-3; float64 logits and gradient <= 1e-3;
    the float32 gradient <= 1e-3 for the Segmenter, and cosine >= 0.9999
    for the ResNet models. Their float32 input gradient routes through
    ReLU gates and max pools that a last-bit difference can flip, and each
    flip deep in the net moves a patch of the gradient: measured on this
    card at 257^2, the CPU's own float32 gradient differs from the float64
    one by up to 2.5e-2 of its largest entry (PSPNet), as much as the
    card's does, while the two devices agree to ~1e-15 in float64. Each
    float32 gradient's error against the CPU's float64 one is printed."""
    import copy
    from robseg_torch.models import ModelBundle
    for name, backbone, n_cls, crop, side in CPU_CHECKS:
        module = family_module(name, backbone, n_cls, crop)
        fn = ModelBundle(module).logits_fn
        g = torch.Generator().manual_seed(4)
        x = torch.rand((1, 3, side, side), generator=g)
        t0 = time.time()
        with torch.no_grad():
            lc = fn(x)
        # labels: the CPU argmax on about half the pixels whose top-2 gap
        # is well above the bound (both devices agree on the mask there),
        # else the lowest-scoring class
        top2 = lc.topk(2, dim=1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2e-3 * float(lc.abs().max())
        pick = sure & (torch.rand(sure.shape, generator=g) < 0.5)
        lab = torch.where(pick, lc.argmax(1), lc.argmin(1))
        lc, gc = mask_ce_run(fn, x, lab)
        m64 = copy.deepcopy(module).double()
        fn64 = ModelBundle(m64).logits_fn
        l64, g64 = mask_ce_run(fn64, x.double(), lab)
        t_cpu = time.time() - t0
        module.to(dev)
        m64.to(dev)
        lk, gk = mask_ce_run(fn, x.to(dev), lab.to(dev))
        l64k, g64k = mask_ce_run(fn64, x.double().to(dev), lab.to(dev))
        lk, gk, l64k, g64k = (t.cpu() for t in (lk, gk, l64k, g64k))
        e = {"logits": rel_max_err(lk, lc), "grad": rel_max_err(gk, gc),
             "logits64": rel_max_err(l64k, l64),
             "grad64": rel_max_err(g64k, g64)}
        cos = cosine(gk, gc)
        e_ref = (rel_max_err(gk.double(), g64), rel_max_err(gc.double(), g64))
        print(f"{name} {backbone} K={n_cls} (1,3,{side},{side}) card vs CPU "
              f"(TF32 off): float32 logits max err {e['logits']:.3e} of "
              f"max|logit| {float(lc.abs().max()):.3e}, input-grad max err "
              f"{e['grad']:.3e} of its largest entry (cosine {cos:.8f}; vs "
              f"the CPU's float64 gradient: card {e_ref[0]:.3e}, CPU "
              f"{e_ref[1]:.3e}); float64 logits "
              f"{e['logits64']:.3e}, input grad {e['grad64']:.3e}; "
              f"mask-ce-avg pixels {int(pick.sum())}; CPU references "
              f"{t_cpu:.1f} s", flush=True)
        grad_ok = (e["grad"] <= 1e-3 if name == "SegMenter"
                   else cos >= 0.9999)
        if not (all(math.isfinite(v) for v in e.values()) and grad_ok
                and max(e["logits"], e["logits64"], e["grad64"]) <= 1e-3):
            raise AssertionError(f"{name}: card vs CPU {e}, cosine {cos}")
        del module, m64, fn, fn64
        torch.cuda.empty_cache()


# the families' attack rates: (label, model, backbone, classes, side,
# precisions); Segmenter-ViT-S/16 on ADE20K, PSPNet-R50 on VOC, the
# Segmenter-SAM (ViT-B/16) once
RATE_MODELS = (
    ("segmenter-vit-s16", "SegMenter", "vit_small_patch16_224", N_ADE, 512,
     ("default", "bf16")),
    ("pspnet-r50", "PSPNet", "ResNet-50", N_CLS, 473, ("default", "bf16")),
    ("segmenter-sam-vit-b16", "SegMenter", "vit_base_patch16_SAM", N_ADE,
     512, ("default",)))


MATMUL_OPS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm")


def op_kind(key: str, shapes, attn_batches) -> str:
    """The kind of work of a profiled PyTorch op that launched kernels
    itself: the attention products are the ``aten::bmm`` calls whose batch
    is batch x heads (forward and backward); the attention's softmax and
    its backward; the convolutions (cuDNN's layout conversions included);
    the other matmuls (linear layers, the resizes' interpolation
    products); everything else is elementwise work, norms and the loss."""
    if key in ("aten::_softmax", "aten::_softmax_backward_data"):
        return "softmax"
    if "convolution" in key:
        return "convolution (cuDNN)"
    if key in MATMUL_OPS:
        if key == "aten::bmm" and shapes and shapes[0] and \
                shapes[0][0] in attn_batches:
            return "attention matmuls"
        return "other matmuls (linear, resize)"
    return "elementwise, norms, loss"


def op_split(fn, reps: int, attn_batches, tries: int = 3):
    """Device ms per call by kind (``op_kind``; the APGD-step kernel,
    launched outside any PyTorch op, by its name), the kernels' total ms
    per call, the wall ms per call and the kernels' rows [(ms, name,
    launches) per call], from one torch.profiler window with shapes over
    ``reps`` calls, taken again while it holds no device time; ({}, 0,
    wall, []) if every window was empty."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        kinds, total, rows = {}, 0.0, []
        for ev in prof.key_averages(group_by_input_shape=True):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us <= 0:
                continue
            ms = us / reps / 1e3
            if str(ev.device_type).endswith("CUDA"):   # a kernel's row
                total += ms
                rows.append((ms, short_name(ev.key), ev.count / reps))
                if "apgd" in ev.key.lower():
                    kinds["APGD step"] = kinds.get("APGD step", 0.0) + ms
                continue
            kind = op_kind(ev.key, getattr(ev, "input_shapes", None),
                           attn_batches)
            kinds[kind] = kinds.get(kind, 0.0) + ms
        if total > 0:
            return kinds, total, wall, sorted(rows, reverse=True)
        print("torch.profiler window with no device time", flush=True)
    return {}, 0.0, wall, []


def phase_family_profile(dev, logits_fn, label, side, n_cls, attn_batches,
                         reps: int = 2):
    """Where one APGD iteration's device time goes on a family model: a
    forward, the input gradient and the APGD-step kernel at batch 16,
    device time by kind (``op_split``) and the idle share."""
    from robseg_torch.kernels import apgd_linf_step
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((BATCH, 3, side, side), device=dev, generator=g)
    y = torch.randint(0, n_cls, (BATCH, side, side), device=dev, generator=g)
    step = torch.full((BATCH, 1, 1, 1), 2 * EPS, device=dev)

    def one():
        _, grad = mask_ce_run(logits_fn, x, y)
        return apgd_linf_step(x, x, x, grad, step, EPS, 0.75)

    one()
    torch.cuda.synchronize()
    kinds, busy, wall, rows = op_split(one, reps, attn_batches)
    if not busy:
        print(f"{label} profile: {wall:.1f} ms wall; time by kind not "
              "measured (torch.profiler recorded no device time in 3 "
              "windows)", flush=True)
        return
    print(f"{label} profile, one forward + input gradient + APGD step at "
          f"batch {BATCH}: {wall:.1f} ms wall, {busy:.1f} ms of kernels, idle "
          f"share {max(0.0, 1 - busy / wall):.4f}; by kind (of "
          f"{sum(kinds.values()):.1f} ms attributed): " + "; ".join(
              f"{k} {v:.2f} ms ({v / busy:.1%})" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"{label} profile, top kernels: " + "; ".join(
        f"{n} {ms:.2f} ms x{c:g}" for ms, n, c in rows[:10]), flush=True)


def phase_family_rates(dev):
    """APGD on the families' models under each precision (phase_apgd's
    protocol). Their profiles (``phase_family_profiles``) run after the
    path's launch counts are read."""
    from robseg_torch.models import ModelBundle
    for label, name, backbone, n_cls, side, precisions in RATE_MODELS:
        module = family_module(name, backbone, n_cls, side).to(dev)
        for precision in precisions:
            fn = ModelBundle(module, precision).logits_fn
            phase_apgd(dev, fn, label=f"{label} {precision}", hw=side,
                       n_cls=n_cls)
        del module, fn
        torch.cuda.empty_cache()


def phase_family_profiles(dev):
    """``phase_family_profile`` for each model and precision of the rates;
    the attention products are the ``aten::bmm`` calls of batch 16 x the
    encoder's or the decoder's heads."""
    from robseg_torch.models import ModelBundle
    from robseg_torch.models import SEGMENTER_VARIANTS
    for label, name, backbone, n_cls, side, precisions in RATE_MODELS:
        module = family_module(name, backbone, n_cls, side).to(dev)
        heads = ({BATCH * SEGMENTER_VARIANTS[backbone]["n_heads"],
                  BATCH * (SEGMENTER_VARIANTS[backbone]["d_model"] // 64)}
                 if name == "SegMenter" else set())
        for precision in precisions:
            fn = ModelBundle(module, precision).logits_fn
            phase_family_profile(dev, fn, f"{label} {precision}", side,
                                 n_cls, heads)
        del module, fn
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 10

TRAIN_PATH = ("convnext_block_fwd", "convnext_block_dx", "apgd_linf_step",
              "confusion_matrix")
UPERNET = ("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST")
TRAIN_BATCH, TRAIN_HW, TRAIN_TIMED = 32, 473, 6


def train_stage_shapes() -> list:
    """The (N, H, W, C) input of each ConvNeXt stage on the train path
    (batch 32 at 473^2), from a forward of the plain module on the meta
    device."""
    from robseg_torch.models import build_model as build
    shapes = []
    with torch.device("meta"):
        m = build(*UPERNET, N_CLS, fused=False).eval()
        for stage in m.backbone.stages:
            stage.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape)))
        m(torch.zeros(TRAIN_BATCH, 3, TRAIN_HW, TRAIN_HW))
    return shapes


def train_inputs(dev, b, hw, k, seed=5):
    """Seeded random images and blocky (32 x 32 regions) labels, no ignore
    pixels (VOC's train labels have none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((b, 3, hw, hw), device=dev, generator=g)
    small = torch.randint(0, k, (b, hw // 32 + 1, hw // 32 + 1), device=dev,
                          generator=g)
    y = small.repeat_interleave(32, 1).repeat_interleave(32, 2)[
        :, :hw, :hw].contiguous()
    return x, y


def upernet_trainer(dev, fused_attack: bool, attack: str = "pgd",
                    group=None):
    """The CLI's UperNet-ConvNeXt-T_CVST trainer (plain module, seeded
    random init, 21 classes): AdamW lr 1e-4, wd 0.05, warmuppolylr (2
    warm-up steps of 100), PGD-5 (or APGD-5) at eps 4/255, alpha 1e-2;
    the attack through the block kernels' twin (on the meta device: it
    takes this step's parameters) or through the plain module;
    data-parallel over ``group`` (rank 0's weights, as the CLI)."""
    from robseg_torch.models import build_model as build
    from robseg_torch.parallel import replicate
    from robseg_torch.train import (AttackConfig, Trainer, get_scheduler,
                                    make_optimizer)
    torch.manual_seed(0)
    module = build(*UPERNET, N_CLS, fused=False).to(dev)
    replicate(module, group)
    twin = None
    if fused_attack:
        with torch.device("meta"):
            twin = build(*UPERNET, N_CLS, fused=True)
    opt = make_optimizer("adamw", module, get_scheduler(
        "warmuppolylr", 1e-4, 100, 1.0, 2, 1e-5), weight_decay=0.05)
    return Trainer(module, UPERNET[0], opt,
                   AttackConfig(name=attack, eps=4 / 255, n_iters=5),
                   twin=twin,
                   generator=torch.Generator(device=dev).manual_seed(0),
                   group=group)


def time_train_steps(trainer, x, y, warm: int, timed_steps: int):
    """(s/step, peak GiB, losses of every step, the StepTimer): ``warm``
    steps, then ``timed_steps`` each timed by ``utils.profiling.
    StepTimer`` on the host's clock, from a device sync to the sync on
    its loss."""
    from robseg_torch.utils.profiling import StepTimer
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(x, y) for _ in range(warm)]
    torch.cuda.synchronize()
    timer = StepTimer()
    for _ in range(timed_steps):
        timer.start()
        losses.append(trainer.train_step(x, y))
        timer.stop(losses[-1])
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    return (timer.mean, torch.cuda.max_memory_allocated() / 2 ** 30,
            losses, timer)


def profile_train_step(trainer, x, y, label: str):
    """torch.profiler split of one train step into its three parts: the
    attack (its 5 forwards and input gradients), the update's forward and
    backward, the optimizer step; kernel time by kind and idle share of
    each."""
    parts = {}
    x_adv = trainer.attack(x, y)

    def update():
        trainer.optimizer.zero_grad()
        trainer.loss_fn(trainer.module, x_adv, y).backward()
    for name, fn in (("attack", lambda: trainer.attack(x, y)),
                     ("update forward+backward", update),
                     ("optimizer", trainer.optimizer.optimizer.step)):
        rows, wall = profiled(fn, 1)
        if not rows:
            parts[name] = f"{wall:.1f} ms wall, split not measured"
            continue
        kinds = {}
        for key, ms, _ in rows:
            kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + ms
        busy = sum(kinds.values())
        parts[name] = (
            f"{wall:.1f} ms wall, {busy:.1f} ms of kernels, idle share "
            f"{max(0.0, 1 - busy / wall):.4f}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in
                sorted(kinds.items(), key=lambda kv: -kv[1])))
    print(f"train-step profile ({label}): " + "; ".join(
        f"{k}: {v}" for k, v in parts.items()), flush=True)


def phase_train_twin(dev):
    """10t, under strict float32 and before the train path's count: the
    fused-attack trainer after one step (moved weights and BatchNorm
    statistics), batch 32 at 473^2. The twin (block kernels) against the
    plain module on the same parameters: logits atol = rtol = 2e-2, the
    input gradient of the PGD loss within 0.15 of its largest entry with
    cosine >= 0.99 (phase 3's bounds). PGD-5 through each: both inside
    the eps ball and [0, 1], and each raises the plain module's loss above
    the clean loss. A backward through the twin with weights that require
    grad must raise."""
    from torch.func import functional_call
    from robseg_torch.attacks.pgd import TRAIN_ATTACK_LOSSES
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    trainer = upernet_trainer(dev, True)
    twin = trainer.twin
    with strict_float32():
        trainer.train_step(x, y)
        trainer.optimizer.zero_grad()

        def logits_and_grad(t):
            trainer.twin = t
            with trainer.attack_model() as lf:
                xg = x.clone().requires_grad_(True)
                logits = lf(xg)
                loss = TRAIN_ATTACK_LOSSES["pgd"](logits, y)
                return logits.detach(), torch.autograd.grad(loss, xg)[0]

        def plain_loss(xa):
            trainer.twin = None
            with torch.no_grad(), trainer.attack_model() as lf:
                return float(TRAIN_ATTACK_LOSSES["pgd"](lf(xa), y))

        lt, gt = logits_and_grad(twin)
        lp, gp = logits_and_grad(None)
        e_l = float((lt - lp).abs().max())
        close = bool(torch.allclose(lt, lp, atol=2e-2, rtol=2e-2))
        e_g = rel_max_err(gt, gp)
        cos = float(torch.nn.functional.cosine_similarity(
            gt.flatten(), gp.flatten(), dim=0))
        del lt, lp, gt, gp
        trainer.twin = twin
        xa_twin = trainer.attack(x, y)
        trainer.twin = None
        xa_plain = trainer.attack(x, y)
        losses = [plain_loss(v) for v in (x, xa_twin, xa_plain)]
    same = float(((xa_twin - xa_plain).abs() <= 1e-6).float().mean())
    dev_max = max(float((v - x).abs().max()) for v in (xa_twin, xa_plain))
    print(f"twin vs plain module (TF32 off; batch {TRAIN_BATCH}, "
          f"{TRAIN_HW}^2, after one train step): logits max_abs_err "
          f"{e_l:.3e}, PGD-loss input-grad rel_max_err {e_g:.3e}, cosine "
          f"{cos:.6f}; PGD-5 adversarial batches equal on a share {same:.5f} "
          f"of entries, max |x_adv - x| {dev_max:.6f} (eps "
          f"{4 / 255:.6f}); plain-module loss clean {losses[0]:.6f}, on the "
          f"twin's x_adv {losses[1]:.6f}, on the plain x_adv "
          f"{losses[2]:.6f}", flush=True)
    if not (close and math.isfinite(e_g) and e_g <= 0.15 and cos >= 0.99):
        raise AssertionError(f"twin vs plain module: logits {e_l}, input "
                             f"grad {e_g}, cosine {cos}")
    if not (dev_max <= 4 / 255 + 1e-6 and losses[1] > losses[0]
            and losses[2] > losses[0]
            and all(float(v.min()) >= 0 and float(v.max()) <= 1
                    for v in (xa_twin, xa_plain))):
        raise AssertionError(f"train attack: max |x_adv - x| {dev_max}, "
                             f"losses (clean, twin, plain) {losses}")
    m = trainer.module
    tensors = dict(m.named_parameters())  # they require grad
    tensors.update(m.named_buffers())
    try:
        functional_call(twin, tensors, (x[:1, :, :64, :64],)).sum().backward()
    except RuntimeError as e:
        if "input gradients only" not in str(e):
            raise
        print("backward through the kernels' twin with weights that "
              "require grad: raises, as it should", flush=True)
    else:
        raise AssertionError("a backward through the block kernel with "
                             "weights that require grad did not raise")
    del trainer, m, tensors, xa_twin, xa_plain
    torch.cuda.empty_cache()


def phase_train_step(dev, smi: str) -> dict:
    """10a: the full-width train step with the fused and the plain attack,
    its profile, the parameters and BatchNorm statistics moving, and one
    eval step (the confusion kernel). Returns (s/step, peak GiB, losses)
    by attack."""
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    out = {}
    for fused in (True, False):
        label = "fused attack" if fused else "plain attack"
        trainer = upernet_trainer(dev, fused)
        m = trainer.module
        p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
        s0 = {n: b.clone() for n, b in m.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
        dt, peak, losses, timer = time_train_steps(trainer, x, y, 2,
                                                   TRAIN_TIMED)
        out[label] = dt, peak, losses
        still = [n for n, p in m.named_parameters()
                 if torch.equal(p.detach(), p0[n])]
        stale = [n for n, b in m.named_buffers() if n in s0
                 and torch.equal(b, s0[n])]
        if still or stale:
            raise AssertionError(f"train step ({label}): parameters that "
                                 f"did not move {still[:5]}, BatchNorm "
                                 f"statistics that did not {stale[:5]}")
        print(f"train step ({label}), UperNet-ConvNeXt-T_CVST, 21 classes, "
              f"batch {TRAIN_BATCH}, {TRAIN_HW}^2, AdamW, PGD-5: "
              f"{dt:.4f} s/step, {TRAIN_BATCH / dt:.2f} train images/s, "
              f"peak {peak:.2f} GiB ({TRAIN_TIMED} timed steps after 2; "
              f"StepTimer {timer.summary()}); losses "
              f"{[round(v, 4) for v in losses]}; all "
              f"{len(p0)} parameters and {len(s0)} BatchNorm statistics "
              f"moved [{smi}]", flush=True)
        profile_train_step(trainer, x, y, label)
        if fused:
            hist = trainer.eval_step(x[:8], y[:8], torch.zeros(
                (N_CLS, N_CLS), device=dev))
            if int(hist.sum()) != y[:8].numel():
                raise AssertionError("eval step histogram does not count "
                                     "every pixel")
        del trainer, m, p0
        torch.cuda.empty_cache()
    return out


def phase_train_apgd(dev, label: str = ""):
    """10b: one step with TRAIN.ATTACK apgd (Linf, random start, ce-avg,
    x_best; the APGD-step kernel) through the fused twin."""
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    trainer = upernet_trainer(dev, True, attack="apgd")
    dt, peak, losses, _ = time_train_steps(trainer, x, y, 1, 1)
    print(f"train step{label} with TRAIN.ATTACK apgd (5 iterations, fused "
          f"twin), batch {TRAIN_BATCH}, {TRAIN_HW}^2: {dt:.4f} s (second "
          f"step), peak {peak:.2f} GiB, losses {losses}", flush=True)
    del trainer
    torch.cuda.empty_cache()


def fixture_voc_train(tmp: str) -> str:
    """The fixture VOC tree with a train split: 48 train and 8 val images
    (tools/make_fixture_dataset.py)."""
    root = os.path.join(tmp, "voc_train")
    if not os.path.isdir(root):
        subprocess.run([sys.executable, os.path.join(
            REPO, "tools", "make_fixture_dataset.py"), "--root", root,
            "--n_train", "48", "--n_val", "8"], check=True)
    return root


def run_train_cli(cfg_path: str, run_dir: str, *flags) -> str:
    p = subprocess.run([sys.executable, "-m", "robseg_torch.train", "--cfg",
                        cfg_path, "--run_dir", run_dir, *flags], cwd=REPO,
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"train CLI exited {p.returncode}:\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    return p.stdout


def phase_train_cli(tmp: str):
    """10c: ``python -m robseg_torch.train`` on the fixture (pascalvoc,
    batch 8, eval every epoch on one batch) for 12 iterations with
    ``--fused_attack``, ``--resume`` to 14, then the SEA CLI on its
    ``best_model.pth``. Returns the launch counts the two train runs
    printed, and the SEA CLI's apart (not the train path's)."""
    import yaml
    root = fixture_voc_train(tmp)
    with open(os.path.join(REPO, "configs", "pascalvoc_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"].update(NAME="pascalvoc", ROOT=root)
    cfg["TRAIN"].update(BATCH_SIZE=8, EVAL_FREQ=1, EVAL_BATCHES=1)
    cfg["SAVE_DIR"] = os.path.join(tmp, "out_train")
    cfg_path = os.path.join(tmp, "cfg_train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    run = os.path.join(tmp, "train_run")
    counts = {}

    def add(out):
        m = re.search(r"^kernel launches: (\{.*\})$", out, re.M)
        if m is None:
            raise AssertionError("train CLI printed no kernel launch counts")
        for k, n in json.loads(m.group(1)).items():
            counts[k] = counts.get(k, 0) + n
    t0 = time.time()
    out = run_train_cli(cfg_path, run, "--max_iters", "12", "--fused_attack")
    losses = [float(v) for v in re.findall(r"Loss: ([0-9.eE+-]+)", out)]
    evals = re.findall(r"val mIoU=([0-9.]+) aAcc=([0-9.]+)", out)
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train CLI losses: {losses}")
    if len(evals) != 2 or "full mIoU" not in out:
        raise AssertionError(f"train CLI evals: {evals}")
    add(out)
    t1 = time.time()
    out2 = run_train_cli(cfg_path, run, "--max_iters", "14", "--resume",
                         "--fused_attack")
    if "Resumed from step 12" not in out2 or "full mIoU" not in out2:
        raise AssertionError("train CLI --resume did not resume at 12")
    add(out2)
    ckpts = sorted(os.listdir(os.path.join(run, "ckpts")))
    best = os.path.join(run, "best_model.pth")
    if not os.path.exists(best):
        raise AssertionError("train CLI wrote no best_model.pth")
    print(f"train CLI (fixture VOC, 48 train / 8 val images, batch 8, "
          f"--fused_attack): 12 iterations in {t1 - t0:.1f} s (process "
          f"included), losses {losses}, evals (mIoU, aAcc) {evals}; resume "
          f"to 14 in {time.time() - t1:.1f} s; checkpoints {ckpts}",
          flush=True)
    sea, _ = phase_cli(tmp, "default", "pascalvoc_convnext.yaml",
                       fixture_voc_train, eps=(4,), n_iter=3, ckpt=best)
    return counts, sea


# (label, model, backbone, config, classes, side): the other families at
# full width, 3 train steps at batch 8 with their config's optimizer
TRAIN_FAMILIES = (
    ("PSPNet-R50", "PSPNet", "ResNet-50", "voc_pspnet.yaml", N_CLS, 473),
    ("Segmenter ViT-S/16", "SegMenter", "vit_small_patch16_224",
     "ade20k_segmenter.yaml", N_ADE, 512))


def phase_train_families(dev, smi: str, timed: int = 2, label: str = ""):
    """10d: 1 + ``timed`` train steps at batch 8 on PSPNet-R50 (SGD, x10
    head scales, 473^2) and Segmenter ViT-S/16 (timm-poly SGD, 512^2, 151
    classes), PGD-5 through the plain module: s/step, peak memory, finite
    loss."""
    import yaml
    from robseg_torch.models import build_model as build
    from robseg_torch.train import AttackConfig, Trainer
    from robseg_torch.train.__main__ import build_optimizer
    for fam, name, backbone, cfg_name, k, side in TRAIN_FAMILIES:
        with open(os.path.join(REPO, "configs", cfg_name)) as f:
            cfg = yaml.safe_load(f)
        torch.manual_seed(0)
        module = build(name, backbone, k, image_size=(side, side),
                       pspnet_clean="clean" in str(cfg.get("ADDENDUM", ""))
                       ).to(dev)
        opt, _ = build_optimizer(cfg, name, module, 100, 10)
        trainer = Trainer(module, name, opt, AttackConfig(
            eps=4 / 255, n_iters=5),
            generator=torch.Generator(device=dev).manual_seed(0))
        x, y = train_inputs(dev, 8, side, k)
        dt, peak, losses, _ = time_train_steps(trainer, x, y, 1, timed)
        print(f"train step{label} {fam} ({cfg_name}, {side}^2, {k} classes, "
              f"batch 8, PGD-5): {dt:.4f} s/step, {8 / dt:.2f} train "
              f"images/s, peak {peak:.2f} GiB, losses "
              f"{[round(v, 4) for v in losses]} [{smi}]", flush=True)
        del trainer, module, opt
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# Phase B: PIR-AT training under bf16 products (the train CLI's --precision
# bf16 and TRAIN.AMP: the port's jax_default_matmul_precision=bfloat16)
# ----------------------------------------------------------------------------

# the kernels the bf16 train path must launch (from zero, before it runs)
BF16_TRAIN_PATH = ("convnext_block_fwd", "convnext_block_dx",
                   "apgd_linf_step", "confusion_matrix")
PRODUCT_TOL = 1e-3  # of max|ref|: TF32 inside cuDNN's transforms, not bf16
PRODUCT_OPS = ("convolution", "convolution_backward", "mm", "bmm", "addmm",
               "baddbmm")


def product_cases(dev):
    """B1's products at the train path's shapes: (label, fn, operands); the
    first two operands are the product's, a third is a bias."""
    from robseg_torch.ops import precision as P
    from robseg_torch.ops.resize import _matrix
    g = torch.Generator(device=dev).manual_seed(11)

    def r(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale
    return [
        ("stem 3x3/s2 conv, 3 -> 48 channels, (2, 3, 473, 473)",
         lambda x, w, b: P.conv2d(x, w, b, 2, 1),
         [r(2, 3, 473, 473), r(48, 3, 3, 3), r(48)]),
        ("depthwise 7x7 conv, stage 1, (2, 192, 59, 59)",
         lambda x, w, b: P.conv2d(x, w, b, 1, 3, 1, 192),
         [r(2, 192, 59, 59), r(192, 1, 7, 7), r(192)]),
        ("3x3 conv 2048 -> 512 at 119^2, batch 2",
         lambda x, w: P.conv2d(x, w, None, 1, 1),
         [r(2, 2048, 119, 119), r(512, 2048, 3, 3, scale=0.01)]),
        ("linear 384 -> 1536, (2, 29, 29, 384)",
         lambda x, w, b: P.linear(x, w, b),
         [r(2, 29, 29, 384), r(1536, 384), r(1536)]),
        ("Segmenter attention q k^T, (2, 6, 1025, 64)",
         lambda q, k: P.matmul(q, k.transpose(-2, -1)),
         [r(2, 6, 1025, 64), r(2, 6, 1025, 64)]),
        ("resize 119 -> 473 along H, (473, 119) @ (2, 21, 119, 119)",
         lambda m, x: P.matmul(m, x),
         [_matrix("bilinear", 119, 473, dev, torch.float32).clone(),
          r(2, 21, 119, 119)]),
    ]


def phase_bf16_products(dev):
    """B1: each product under the mode on the card (matmuls bf16 cuBLAS
    with a float32 output, convolutions on rounded operands under TF32)
    against float64 on the same rounded operands: forward, and the two
    product operands' gradients from a rounded cotangent, each within
    1e-3 of the reference's largest entry; and the ms of a forward and
    both gradients under the mode beside the same call under the CLI's
    ``default`` numerics (TF32). Returns the errors by case."""
    from robseg_torch.ops.precision import bf16_products, round_bf16
    errs = {}
    for label, fn, ops in product_cases(dev):
        ops = [t.requires_grad_(True) for t in ops]
        with bf16_products():
            y = fn(*ops)
            g = torch.randn(y.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(12))
            dgot = torch.autograd.grad(y, ops[:2], g)

        def fwd_bwd():
            torch.autograd.grad(fn(*ops), ops[:2], g)
        with bf16_products():
            ms = cuda_ms(fwd_bwd)
        ms_default = cuda_ms(fwd_bwd)
        ref = [round_bf16(t.detach()).double().requires_grad_(True)
               for t in ops[:2]] + [t.detach().double() for t in ops[2:]]
        with strict_float32():
            yr = fn(*ref)
            dref = torch.autograd.grad(yr, ref[:2], round_bf16(g).double())
        e = [rel_max_err(a.double(), b) for a, b in
             zip((y.detach(),) + dgot, (yr.detach(),) + dref)]
        errs[label] = e
        print(f"bf16 product {label}: error / max|ref| against float64 on "
              f"the rounded operands: forward {e[0]:.3e}, d{{op 1}} "
              f"{e[1]:.3e}, d{{op 2}} {e[2]:.3e}; forward + both "
              f"gradients {ms:.3f} ms, under default (TF32) "
              f"{ms_default:.3f} ms", flush=True)
        if not all(math.isfinite(v) and v <= PRODUCT_TOL for v in e):
            raise AssertionError(f"bf16 product {label}: errors {e}")
        del ops, y, dgot, ref, yr, dref
    torch.cuda.empty_cache()
    return errs


class ProductOperands(TorchDispatchMode):
    """Counts the product calls (forward and backward) and names those
    with a floating operand that is not bf16-representable."""

    def __init__(self):
        super().__init__()
        self.calls, self.bad = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from robseg_torch.ops.precision import round_bf16
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in PRODUCT_OPS:
            self.calls[name] = self.calls.get(name, 0) + 1
            for a in list(args) + list(kwargs.values()):
                if (isinstance(a, torch.Tensor) and a.is_floating_point()
                        and not torch.equal(a, round_bf16(a))):
                    self.bad.append(str(func))
                    break
        return func(*args, **kwargs)


def phase_bf16_coverage(dev):
    """B1, the CPU test's coverage check once on the card: under the mode
    every convolution, convolution backward and matmul of the plain
    UperNet's train-mode loss and backward and of its eval-mode input
    gradient (batch 2, 473^2) takes only bf16-representable operands; the
    same run with the mode off must trip the check."""
    from robseg_torch.models import build_model as build
    from robseg_torch.ops.precision import bf16_products
    torch.manual_seed(0)
    m = build(*UPERNET, N_CLS, fused=False).to(dev)
    x, y = train_inputs(dev, 2, TRAIN_HW, N_CLS)

    def run():
        m.train()(x, y)[0].backward()
        xg = x.clone().requires_grad_(True)
        m.eval()(xg).logsumexp(1).sum().backward()
    seen = {}
    for on in (True, False):
        with bf16_products(on), ProductOperands() as mode:
            run()
        seen[on] = mode
    on, off = seen[True], seen[False]
    print(f"bf16 coverage on the card (plain UperNet, batch 2, {TRAIN_HW}^2, "
          f"train loss + backward, eval input gradient): product calls "
          f"{on.calls}, {len(on.bad)} with an operand that is not "
          f"bf16-representable; with the mode off {len(off.bad)} of "
          f"{sum(off.calls.values())}", flush=True)
    if on.bad or not on.calls.get("convolution_backward") or not off.bad:
        raise AssertionError(f"bf16 coverage: {sorted(set(on.bad))}, "
                             f"calls {on.calls}, off {len(off.bad)}")
    del m
    torch.cuda.empty_cache()


def phase_bf16_train_step(dev, smi: str, ref: dict):
    """B2: the full-width train step (10a's, fused twin) under bf16
    products: 2 warm-up and 6 timed steps beside 10a's ``default`` step
    (``ref``) from this run, the first 4 losses of both from the same
    seed and weights, every parameter moved; then one TRAIN.ATTACK apgd
    step under the mode."""
    from robseg_torch.ops.precision import bf16_products
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    trainer = upernet_trainer(dev, True)
    m = trainer.module
    p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    with bf16_products():
        dt, peak, losses, timer = time_train_steps(trainer, x, y, 2,
                                                   TRAIN_TIMED)
    still = [n for n, p in m.named_parameters()
             if torch.equal(p.detach(), p0[n])]
    if still:
        raise AssertionError(f"bf16 train step: parameters that did not "
                             f"move {still[:5]}")
    dt0, peak0, losses0 = ref["fused attack"]
    print(f"train step (fused attack) under bf16 products, UperNet-ConvNeXt-"
          f"T_CVST, batch {TRAIN_BATCH}, {TRAIN_HW}^2, AdamW, PGD-5: "
          f"{dt:.4f} s/step, {TRAIN_BATCH / dt:.2f} train images/s, peak "
          f"{peak:.2f} GiB (StepTimer {timer.summary()}); default in this "
          f"run (10a): {dt0:.4f} s/step, {TRAIN_BATCH / dt0:.2f} train "
          f"images/s, peak {peak0:.2f} GiB; all {len(p0)} parameters moved "
          f"[{smi}]", flush=True)
    print(f"first 4 losses, same seed and weights: default "
          f"{[round(v, 6) for v in losses0[:4]]}, bf16 products "
          f"{[round(v, 6) for v in losses[:4]]}", flush=True)
    with bf16_products():
        profile_train_step(trainer, x, y, "fused attack, bf16 products")
    del trainer, m, p0
    torch.cuda.empty_cache()
    with bf16_products():
        phase_train_apgd(dev, label=" under bf16 products")
    torch.cuda.empty_cache()
    return dt, peak


def phase_autocast_record(dev, smi: str, ref: dict):
    """For the record only, not a mode of the CLI: one step (after one
    warm-up) of the plain-attack trainer under torch.autocast(bf16),
    beside 10a's plain-attack ``default`` step. A failure is printed, not
    raised: autocast is no part of the port."""
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    trainer = upernet_trainer(dev, False)
    dt0, peak0, _ = ref["plain attack"]
    try:
        with torch.autocast("cuda", torch.bfloat16):
            dt, peak, losses, _ = time_train_steps(trainer, x, y, 1, 1)
        print(f"record only: train step (plain attack) under torch.autocast"
              f"(bfloat16): {dt:.4f} s (second step), {TRAIN_BATCH / dt:.2f}"
              f" train images/s, peak {peak:.2f} GiB, losses {losses}; "
              f"default plain-attack step (10a) {dt0:.4f} s, peak "
              f"{peak0:.2f} GiB [{smi}]", flush=True)
    except RuntimeError as e:
        print(f"record only: autocast step not measured ({e})", flush=True)
    del trainer
    torch.cuda.empty_cache()


def phase_bf16_train_cli(tmp: str) -> dict:
    """B4: ``python -m robseg_torch.train --fused_attack`` on a fixture VOC
    tree (16 train, 8 val images; batch 8, an eval at iteration 2) for 2
    iterations with ``--precision bf16``, then with ``TRAIN.AMP: true``
    under ``--precision default``: each exits 0, logs ``precision: bf16``
    and a finite loss, and writes best_model.pth. Returns the launch
    counts the two runs printed."""
    import yaml
    root = os.path.join(tmp, "voc_train16")
    subprocess.run([sys.executable, os.path.join(
        REPO, "tools", "make_fixture_dataset.py"), "--root", root,
        "--n_train", "16", "--n_val", "8"], check=True)
    counts = {}
    for flag, amp in (("bf16", False), ("default", True)):
        with open(os.path.join(REPO, "configs",
                               "pascalvoc_convnext.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["DATASET"].update(NAME="pascalvoc", ROOT=root)
        cfg["TRAIN"].update(BATCH_SIZE=8, EVAL_FREQ=1, EVAL_BATCHES=1,
                            AMP=amp)
        cfg["SAVE_DIR"] = os.path.join(tmp, "out_bf16")
        cfg_path = os.path.join(tmp, f"cfg_bf16_{flag}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        run = os.path.join(tmp, f"train_bf16_{flag}")
        t0 = time.time()
        out = run_train_cli(cfg_path, run, "--max_iters", "2",
                            "--fused_attack", "--precision", flag)
        losses = [float(v) for v in re.findall(r"Loss: ([0-9.eE+-]+)", out)]
        m = re.search(r"^kernel launches: (\{.*\})$", out, re.M)
        if not (re.search(r"^precision: bf16 \(", out, re.M) and losses
                and all(math.isfinite(v) for v in losses) and m
                and os.path.exists(os.path.join(run, "best_model.pth"))):
            raise AssertionError(f"train CLI --precision {flag}, TRAIN.AMP "
                                 f"{amp}: {out[-3000:]}")
        for k, n in json.loads(m.group(1)).items():
            counts[k] = counts.get(k, 0) + n
        print(f"train CLI --precision {flag}, TRAIN.AMP {amp} (fixture VOC, "
              f"16 train / 8 val, batch 8, --fused_attack): 2 iterations in "
              f"{time.time() - t0:.1f} s (process included), logs precision "
              f"bf16, losses {losses}, best_model.pth written", flush=True)
    return counts


def phase_utilities(dev, tmp: str):
    """B5: ``utils.profiling.trace`` around one main-path APGD iteration
    (batch 16, 512^2) writes a non-empty Chrome trace with CUDA kernel
    events (an empty window taken again up to 3 times, as ``profiled``
    does); ``utils.flops.cost_analysis`` of the plain UperNet forward at
    batch 16, 512^2 (FlopCounterMode counts torch's products, not the
    block kernels', so the plain module)."""
    from robseg_torch.attacks.apgd import apgd_attack
    from robseg_torch.models import build_model as build
    from robseg_torch.utils.flops import cost_analysis
    from robseg_torch.utils.profiling import trace
    bundle = build_model(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((BATCH, 3, HW, HW), device=dev, generator=g)
    y = torch.randint(0, N_CLS, (BATCH, HW, HW), device=dev, generator=g)

    def one_iteration():
        apgd_attack(bundle.logits_fn, x, y, norm="Linf", eps=EPS, n_iter=1,
                    use_rs=True, loss="mask-ce-avg", track_loss="ce-avg",
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).acc.cpu()
    one_iteration()
    for attempt in range(3):
        log_dir = os.path.join(tmp, f"trace{attempt}")
        with trace(log_dir):
            one_iteration()
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        with open(files[0]) as f:
            events = json.load(f).get("traceEvents", [])
        kernels_ = [e for e in events if e.get("cat") == "kernel"]
        if kernels_:
            break
        print("utils.profiling.trace: window with no device time",
              flush=True)
    if not kernels_:
        raise AssertionError("utils.profiling.trace wrote no CUDA kernel "
                             "event in 3 windows")
    busy = sum(e.get("dur", 0) for e in kernels_) / 1e3
    print(f"utils.profiling.trace around one main-path APGD iteration "
          f"(batch {BATCH}, {HW}^2): {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(kernels_)} CUDA kernel "
          f"events, {busy:.1f} ms of kernels", flush=True)
    del bundle
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    m = build(*UPERNET, N_CLS, fused=False).to(dev).eval()
    with torch.no_grad():
        ca = cost_analysis(m, x)
    print(f"utils.flops.cost_analysis of the UperNet-ConvNeXt-T_CVST forward "
          f"(plain module, batch {BATCH}, {HW}^2): "
          f"{ca['flops'] / 1e9:.1f} GFLOPs", flush=True)
    del m
    torch.cuda.empty_cache()


def phases_bf16_train(dev, smi: str, ref: dict) -> dict:
    """Phase B: B1 (products and coverage), then B2-B4 counted from zero
    (the train CLI's printed counts added), then the autocast record and
    B5. Returns the bf16 train path's launch counts."""
    from robseg_torch import kernels
    from robseg_torch.ops.precision import bf16_products
    with timed("B1 bf16 products"):
        phase_bf16_products(dev)
        phase_bf16_coverage(dev)
    kernels.reset_launch_counts()
    with timed("B2 bf16 train step"):
        phase_bf16_train_step(dev, smi, ref)
    with timed("B3 bf16 train families"), bf16_products():
        phase_train_families(dev, smi, timed=1,
                             label=" under bf16 products")
    with tempfile.TemporaryDirectory() as tmp:
        with timed("B4 bf16 train CLI"):
            cli_counts = phase_bf16_train_cli(tmp)
        counts = kernels.launch_counts()
        for name, n in cli_counts.items():
            counts[name] += n
        with timed("B5 autocast record, utilities"):
            phase_autocast_record(dev, smi, ref)
            phase_utilities(dev, tmp)
    return counts


# ----------------------------------------------------------------------------
# The worst-case engines, the other norms, multi-scale + flip and ADE20K
# training with on-device augmentation
# ----------------------------------------------------------------------------

# the kernels each of these paths must launch (from zero, before it runs)
NORMS_PATH = ("convnext_block_fwd", "convnext_block_dx", "apgd_linf_step",
              "confusion_matrix")
MSF_PATH = ("convnext_block_fwd", "confusion_matrix")
ADE_TRAIN_PATH = ("convnext_block_fwd", "convnext_block_dx",
                  "confusion_matrix")
EPS_L2, EPS_L1 = 4.0, 64.0  # both projections act from the first steps
WC_SHAPE = (3, 2000, 151)   # SEA's attacks x ADE20K's val images x classes


def worst_case_instance(shape=WC_SHAPE, seed=0, absent=20):
    """Seeded (A, N, K) intersections and unions with ``absent`` classes
    absent everywhere (what the reference engines' shrink reads)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 50, shape).astype(np.float64)
    unis = ints + rng.integers(0, 80, shape).astype(np.float64)
    drop = rng.choice(shape[-1], absent, replace=False)
    ints[:, :, drop] = 0
    unis[:, :, drop] = 0
    return ints, unis


def phase_worst_case():
    """W: build libworst_case with g++ and run the four engines on an
    ADE-sized input. The JAX package's tests hold: the native minimum
    close to the Python one (within 0.02) and not above the start; the
    reference pair trajectory-identical (same selection, mIoU within
    1e-12); ``auto`` is ``native``."""
    from robseg_torch.attacks.worst_case import _miou_from, worst_case_miou
    from robseg_torch.kernels import _build
    t0 = time.time()
    _build.native_library("worst_case")
    build_s = time.time() - t0
    ints, unis = worst_case_instance()
    res, secs = {}, {}
    for eng in ("native", "auto", "python", "reference", "reference-python"):
        t0 = time.time()
        res[eng] = worst_case_miou(ints, unis, engine=eng,
                                   return_selection=True)
        secs[eng] = time.time() - t0
    start = _miou_from(ints[0].sum(0), unis[0].sum(0))
    print(f"worst case (A, N, K) = {WC_SHAPE}: g++ build {build_s:.2f} s; "
          + "; ".join(f"{e} {secs[e]:.3f} s, final_miou {res[e][0]:.10f}"
                      for e in res) + f"; start {start:.10f}", flush=True)
    if not (res["auto"][0] == res["native"][0]
            and np.array_equal(res["auto"][1], res["native"][1])):
        raise AssertionError("worst case: auto is not native")
    if not (abs(res["python"][0] - res["native"][0]) < 0.02
            and res["native"][0] <= start + 1e-9):
        raise AssertionError(f"worst case: native {res['native'][0]}, "
                             f"python {res['python'][0]}, start {start}")
    if not (np.array_equal(res["reference"][1], res["reference-python"][1])
            and abs(res["reference"][0] - res["reference-python"][0])
            < 1e-12):
        raise AssertionError("worst case: the reference engines differ")


def pert_norms(adv, x) -> dict:
    """Per-image Linf, L2 and L1 norms of ``adv - x``, and the range and
    NaN count of ``adv`` (chip_smoke's check_imgs)."""
    d = (adv - x).reshape(adv.shape[0], -1).double()
    return {"Linf": d.abs().amax(1), "L2": d.pow(2).sum(1).sqrt(),
            "L1": d.abs().sum(1), "min": float(adv.min()),
            "max": float(adv.max()), "nan": int(torch.isnan(adv).sum())}


def check_in_ball(label, adv, x, norm, eps, active=None):
    """``adv`` finite, in [0, 1] and in the ``norm`` ball of radius eps
    (relative slack 1e-4 for the float32 projections); with ``active``,
    the largest perturbation is at least that share of eps (the
    projection acted)."""
    n = pert_norms(adv, x)
    top = float(n[norm].max())
    if not (n["nan"] == 0 and n["min"] >= 0.0 and n["max"] <= 1.0
            and top <= eps * (1 + 1e-4) + 1e-6):
        raise AssertionError(f"{label}: outside the ball or box: {norm} "
                             f"{top} (eps {eps}), {n['min']}..{n['max']}, "
                             f"nan {n['nan']}")
    if active is not None and top < active * eps:
        raise AssertionError(f"{label}: largest {norm} {top}, below "
                             f"{active} x eps {eps}: projection inactive")
    return top


def phase_norms(dev, logits_fn, smi: str):
    """N: the rest of the attack engine on UperNet-ConvNeXt-T_CVST, batch
    16, 512^2, 21 classes (mask-ce-avg tracking ce-avg, no random start,
    which is Linf only): run_attack_over_loader under L2 and L1 raises as
    the JAX function does (apgd_largereps projects between its phases in
    Linf only), so their attacks run through apgd_attack, 10 and 4
    iterations (whole-run and marginal step*imgs/s); run_attack_over_loader
    under Linf (10 iterations); apgd_restarts with ce-targeted, 2 x 10
    Linf; pgd_filters, 10 iterations; iou_acc_summary of each result.
    Every result inside its ball and [0, 1], and the attacked per-image
    accuracy not above the clean one."""
    from robseg_torch.attacks import (apgd_attack, apgd_restarts,
                                      pgd_filters, run_attack_over_loader)
    from robseg_torch.attacks.apgd import _per_image_acc
    from robseg_torch.ops import iou_acc_summary
    x, y = train_inputs(dev, BATCH, HW, N_CLS, seed=9)
    with torch.no_grad():
        clean_logits = logits_fn(x)
    clean_acc = _per_image_acc(clean_logits, y, -1, False)
    summary = {}

    def record(label, adv, acc=None):
        """iou_acc_summary of the model on ``adv``; the per-image
        accuracy (the attack's own, else recomputed: 1e-3 of slack for
        argmax ties that a second forward breaks otherwise) not above the
        clean one."""
        with torch.no_grad():
            pred = logits_fn(adv).argmax(1)
        summary[label] = [float(v) for v in iou_acc_summary(
            pred, y, num_classes=N_CLS)]
        if acc is None:
            acc = (pred == y).float().reshape(BATCH, -1).mean(1)
        if bool((acc > clean_acc + 1e-3).any()):
            raise AssertionError(f"{label}: attacked accuracy above the "
                                 f"clean one: {acc} vs {clean_acc}")

    for norm in ("L2", "L1"):
        try:
            run_attack_over_loader(logits_fn, [(x, y)], loss="mask-ce-avg",
                                   eps=1.0, n_iter=4, norm=norm,
                                   use_rs=False, device=dev)
        except NotImplementedError:
            pass
        else:
            raise AssertionError(f"run_attack_over_loader accepted {norm}")
    for norm, eps in (("L2", EPS_L2), ("L1", EPS_L1)):
        def run(it, norm=norm, eps=eps):
            res = apgd_attack(logits_fn, x, y, norm=norm, eps=eps,
                              n_iter=it, use_rs=False, loss="mask-ce-avg",
                              track_loss="ce-avg", n_iter_buf=10)
            res.acc.cpu()
            return res
        run(2)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run(4)
        t1 = time.perf_counter()
        res = run(10)
        t2 = time.perf_counter()
        top = check_in_ball(f"{norm} APGD", res.x_best_adv, x, norm, eps,
                            active=0.9)
        record(f"{norm} APGD", res.x_best_adv, res.acc)
        per_iter = ((t2 - t1) - (t1 - t0)) / 6
        print(f"apgd {norm} ({BATCH},3,{HW},{HW}) eps {eps:g} mask-ce-avg"
              f"/ce-avg: whole-run {10 * BATCH / (t2 - t1):.2f} "
              f"step*imgs/s, marginal {BATCH / per_iter:.2f} step*imgs/s "
              f"({per_iter * 1e3:.1f} ms/iteration), peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"largest {norm} perturbation {top:.5f}; mean acc clean "
              f"{float(clean_acc.mean()):.4f} -> "
              f"{float(res.acc.mean()):.4f} [{smi}]", flush=True)
    t0 = time.time()
    ((adv, _),) = run_attack_over_loader(
        logits_fn, [(x, y)], loss="mask-ce-avg", eps=EPS, n_iter=10,
        use_rs=False, device=dev)
    adv = torch.as_tensor(adv, device=dev)
    check_in_ball("run_attack_over_loader Linf", adv, x, "Linf", EPS)
    record("loader Linf", adv)
    t_loader = time.time() - t0
    t0 = time.time()
    adv, _, acc = apgd_restarts(
        logits_fn, x, y, norm="Linf", eps=EPS, n_iter=10, loss="ce-targeted",
        n_restarts=2, track_loss="ce-avg", n_target_classes=N_CLS)
    acc.cpu()
    t_restarts = time.time() - t0
    check_in_ball("apgd_restarts", adv, x, "Linf", EPS)
    record("restarts ce-targeted", adv, acc)
    t0 = time.time()
    y_img = torch.randint(0, 10, (BATCH,), device=dev,
                          generator=torch.Generator(dev).manual_seed(4))
    xf, f = pgd_filters(logits_fn, x, y, y_img, n_iter=10, n_cls=10,
                        generator=torch.Generator(dev).manual_seed(5))
    xf.cpu()
    t_filters = time.time() - t0
    if not (bool(torch.isfinite(xf).all()) and float(f.min()) >= 0
            and float(f.max()) <= 1):
        raise AssertionError("pgd_filters: non-finite images or filters "
                             "outside [0, 1]")
    with torch.no_grad():
        pred = logits_fn(xf).argmax(1)
    summary["pgd_filters"] = [float(v) for v in iou_acc_summary(
        pred, y, num_classes=N_CLS)]
    summary["clean"] = [float(v) for v in iou_acc_summary(
        clean_logits.argmax(1), y, num_classes=N_CLS)]
    print(f"run_attack_over_loader Linf (10 iterations, largereps) "
          f"{t_loader:.2f} s; apgd_restarts ce-targeted 2 x 10 Linf "
          f"{t_restarts:.2f} s; pgd_filters 10 iterations {t_filters:.2f} "
          f"s; iou_acc_summary (mAcc, aAcc, mIoU): {json.dumps(summary)} "
          f"[{smi}]", flush=True)


def phase_msf(dev, tmp, logits_fn, smi: str) -> dict:
    """M: multi_scale_flip_logits on one fixture VOC batch (8 images,
    473^2, scales 256/384/480/608/736 and their flips) against the same
    call with every kernel routed to its plain version, TF32 off, within
    phase 3's logits bound (atol = rtol = 2e-2, here on the summed
    probabilities); then the SEA CLI with ``--no-adversarial --msf`` and
    configs/pascalvoc_convnext.yaml on the fixture. Returns the CLI's
    launch counts (the comparison's are not the path's)."""
    import yaml
    from robseg_torch.data import get_segmentation_dataset, simple_eval_loader
    from robseg_torch.infer import MSF_SCALES
    from robseg_torch.utils.sliding_window import multi_scale_flip_logits
    root = fixture_voc(tmp)
    ds = get_segmentation_dataset("pascalvoc", root=root, split="val",
                                  crop_size=473)
    xn, _ = next(simple_eval_loader(ds, 8, 1))
    x = torch.tensor(xn, device=dev)
    with strict_float32(), torch.no_grad():
        def msf():
            return multi_scale_flip_logits(logits_fn, x, scales=MSF_SCALES,
                                           flip=True, num_classes=N_CLS)
        pk = msf()
        with plain_kernels():
            pp = msf()
    err = float((pk - pp).abs().max())
    agree = float((pk.argmax(1) == pp.argmax(1)).float().mean())
    print(f"multi_scale_flip_logits (8,3,473,473), scales {MSF_SCALES} + "
          f"flips, TF32 off: kernels vs plain max_abs_err {err:.3e} on "
          f"summed probabilities (max {float(pp.max()):.3f}), argmax "
          f"agreement {agree:.5f}", flush=True)
    torch.testing.assert_close(pk, pp, atol=2e-2, rtol=2e-2)
    del pk, pp
    with open(os.path.join(REPO, "configs", "pascalvoc_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"]["ROOT"] = root
    cfg["SAVE_DIR"] = os.path.join(tmp, "out_msf")
    cfg_path = os.path.join(tmp, "cfg_msf.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "robseg_torch.infer", "--cfg",
                        cfg_path, "--no-adversarial", "--msf"], cwd=REPO,
                       capture_output=True, text=True)
    wall = time.time() - t0
    if p.returncode != 0:
        raise RuntimeError(f"SEA CLI --msf exited {p.returncode}:\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    m = re.search(r"MSF clean performance: (\{.*\})", p.stdout)
    c = re.search(r"^kernel launches: (\{.*\})$", p.stdout, re.M)
    if m is None or c is None:
        raise AssertionError("SEA CLI --msf printed no MSF stats or no "
                             "launch counts")
    stats = ast.literal_eval(m.group(1))
    if not all(0.0 <= v <= 1.0 for v in stats.values()):
        raise AssertionError(f"MSF stats {stats}")
    counts = json.loads(c.group(1))
    print(f"SEA CLI --no-adversarial --msf (pascalvoc_convnext.yaml, 8 "
          f"fixture images at 473^2, one batch) in {wall:.1f} s (process "
          f"included): MSF clean performance {stats}; launches {counts} "
          f"[{smi}]", flush=True)
    return counts


def fixture_ade_train(tmp: str) -> str:
    """An ADE20K-layout tree with a train split: 32 training images of
    four sizes (one above the 1040 buffer's edge, so the host resizes it)
    and 8 validation images, piecewise-constant labels 0..150."""
    from PIL import Image
    root = os.path.join(tmp, "ade_train")
    base = os.path.join(root, "ADEChallengeData2016")
    if os.path.isdir(base):
        return root
    sizes = ((512, 683), (600, 800), (384, 512), (1200, 900))
    for split, n, tag in (("training", 32, "train"),
                          ("validation", 8, "val")):
        img_dir = os.path.join(base, "images", split)
        ann_dir = os.path.join(base, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(n):
            rng = np.random.default_rng(300 + i + (100 if tag == "val"
                                                   else 0))
            h, w = sizes[i % 4] if tag == "train" else (512, 640)
            small = rng.integers(0, N_ADE, (h // 64 + 1, w // 64 + 1))
            lab = np.kron(small.astype(np.uint8),
                          np.ones((64, 64), np.uint8))[:h, :w]
            img = rng.random((h, w, 3)) * 128 + (lab[..., None] % 64) * 2
            stem = f"ADE_{tag}_{i:08d}"
            Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
                os.path.join(img_dir, stem + ".jpg"))
            Image.fromarray(lab).save(os.path.join(ann_dir, stem + ".png"))
    return root


def ade_train_cfg(tmp: str, root: str, **train) -> str:
    """configs/ade20k_convnext.yaml with its ROOT and SAVE_DIR in
    ``tmp``, ``DEVICE_AUG: true`` and the TRAIN keys given."""
    import yaml
    with open(os.path.join(REPO, "configs", "ade20k_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"]["ROOT"] = root
    cfg["SAVE_DIR"] = os.path.join(tmp, "out_ade_train")
    cfg["TRAIN"].update(DEVICE_AUG=True, **train)
    path = os.path.join(tmp, "cfg_ade_train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_ade_train(dev, tmp, smi: str) -> dict:
    """A: configs/ade20k_convnext.yaml's step (UperNet-ConvNeXt-T_CVST,
    151 classes, batch 16, 512^2, PGD-20 at eps 4/255 through the block
    kernels' twin, AdamW with the config's schedule) on DEVICE_AUG batches
    from the ADE20K fixture's train split (1040^2 buffers, augment_batch on
    the card): 2 warm-up and 4 timed steps; augment_batch's ms a batch-16
    call (CUDA events) beside the host pipeline's (PIL
    train_sync_transform, IterationBasedLoader) and load_raw_batch's ms a
    batch; then the train CLI with DEVICE_AUG: true at batch 8 for 4
    iterations (an eval and a checkpoint at the epoch's end) and
    --resume to 5. Returns the launch counts of the steps and the CLI
    runs."""
    import yaml
    from robseg_torch import kernels
    from robseg_torch.data import IterationBasedLoader, get_segmentation_dataset
    from robseg_torch.data.device_transforms import (augment_batch,
                                                     load_raw_batch)
    from robseg_torch.models import build_model as build
    from robseg_torch.train import AttackConfig, Trainer
    from robseg_torch.train.__main__ import build_optimizer
    root = fixture_ade_train(tmp)
    with open(os.path.join(REPO, "configs", "ade20k_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    t = cfg["TRAIN"]
    base, crop, bs = t["BASE_SIZE"], t["IMAGE_SIZE"][0], t["BATCH_SIZE"]
    buf = 2 * base
    ds = get_segmentation_dataset("ade20k", root=root, split="train",
                                  mode="train", base_size=base,
                                  crop_size=crop)
    idx = np.arange(bs) % len(ds)
    t0 = time.perf_counter()
    raw = load_raw_batch(ds, idx, buffer_hw=(buf, buf), max_edge=buf)
    raw_ms = (time.perf_counter() - t0) * 1e3
    imgs = torch.from_numpy(raw[0]).to(dev).permute(0, 3, 1, 2).contiguous()
    msks = torch.from_numpy(raw[1]).to(dev)
    valid = torch.from_numpy(raw[2]).to(dev)
    gen = torch.Generator(dev).manual_seed(7)
    aug_ms = cuda_ms(lambda: augment_batch(imgs, msks, valid, gen,
                                           base_size=base, crop_size=crop))
    host = iter(IterationBasedLoader(ds, batch_size=bs, max_iters=3))
    next(host)
    t0 = time.perf_counter()
    next(host)
    next(host)
    host_ms = (time.perf_counter() - t0) / 2 * 1e3
    batches = [augment_batch(imgs, msks, valid, gen, base_size=base,
                             crop_size=crop) for _ in range(6)]
    xs, ys = batches[0]
    if not (xs.shape == (bs, 3, crop, crop) and ys.shape == (bs, crop, crop)
            and float(xs.min()) >= 0 and float(xs.max()) <= 1
            and int(ys.min()) >= 0 and int(ys.max()) < N_ADE):
        raise AssertionError("augment_batch: shapes or ranges")
    print(f"DEVICE_AUG ({bs} ADE20K fixture images, {buf}^2 buffers -> "
          f"{crop}^2 crops): augment_batch {aug_ms:.3f} ms a call on the "
          f"card; load_raw_batch {raw_ms:.1f} ms a batch on the host; the "
          f"host pipeline (PIL train_sync_transform) {host_ms:.1f} ms a "
          f"batch [{smi}]", flush=True)

    kernels.reset_launch_counts()
    torch.manual_seed(0)
    name, backbone = cfg["MODEL"]["NAME"], cfg["MODEL"]["BACKBONE"]
    module = build(name, backbone, N_ADE, image_size=(crop, crop),
                   fused=False).to(dev)
    with torch.device("meta"):
        twin = build(name, backbone, N_ADE, fused=True)
    opt, _ = build_optimizer(cfg, name, module, 100, 10)
    trainer = Trainer(module, name, opt, AttackConfig(
        name=t["ATTACK"], loss_fn=t["LOSS_FN"], eps=t["EPS"] / 255,
        n_iters=t["N_ITERS"]), twin=twin,
        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    for xb, yb in batches[:2]:
        trainer.train_step(xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(xb, yb) for xb, yb in batches[2:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 4
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ADE20K train losses {losses}")
    hist = trainer.eval_step(xs[:8], ys[:8], torch.zeros(
        (N_ADE, N_ADE), device=dev))
    if int(hist.sum()) != ys[:8].numel():
        raise AssertionError("ADE20K eval step histogram")
    print(f"train step ADE20K (ade20k_convnext.yaml: UperNet-ConvNeXt-"
          f"T_CVST, {N_ADE} classes, batch {bs}, {crop}^2, PGD-"
          f"{t['N_ITERS']} at eps {t['EPS']}/255, AdamW, --fused_attack, "
          f"DEVICE_AUG batches): {dt:.4f} s/step, {bs / dt:.2f} train "
          f"images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (4 timed steps after 2); losses "
          f"{[round(v, 4) for v in losses]} [{smi}]", flush=True)
    counts = kernels.launch_counts()
    del trainer, module, twin, opt, batches, xs, ys, imgs
    torch.cuda.empty_cache()

    cfg_path = ade_train_cfg(tmp, root, BATCH_SIZE=8, EVAL_FREQ=1,
                             EVAL_BATCHES=1)
    run = os.path.join(tmp, "ade_train_run")
    t0 = time.time()
    out = run_train_cli(cfg_path, run, "--max_iters", "4", "--fused_attack")
    t1 = time.time()
    out2 = run_train_cli(cfg_path, run, "--max_iters", "5", "--resume",
                         "--fused_attack")
    t2 = time.time()
    cli_losses = [float(v) for v in re.findall(r"Loss: ([0-9.eE+-]+)", out)]
    evals = re.findall(r"val mIoU=([0-9.]+) aAcc=([0-9.]+)", out)
    if not (len(cli_losses) == 2 and all(map(math.isfinite, cli_losses))
            and len(evals) == 1 and "full mIoU" in out):
        raise AssertionError(f"ADE20K train CLI: losses {cli_losses}, "
                             f"evals {evals}")
    if "Resumed from step 4" not in out2 or "full mIoU" not in out2:
        raise AssertionError("ADE20K train CLI --resume did not resume at 4")
    for o in (out, out2):
        m = re.search(r"^kernel launches: (\{.*\})$", o, re.M)
        if m is None:
            raise AssertionError("train CLI printed no kernel launch counts")
        for k, n in json.loads(m.group(1)).items():
            counts[k] += n
    print(f"train CLI ADE20K fixture (32 train / 8 val images, batch 8, "
          f"DEVICE_AUG: true, --fused_attack): 4 iterations in "
          f"{t1 - t0:.1f} s (process included), losses {cli_losses}, evals "
          f"(mIoU, aAcc) {evals}; --resume to 5 in {t2 - t1:.1f} s; "
          f"checkpoints {sorted(os.listdir(os.path.join(run, 'ckpts')))}",
          flush=True)
    return counts


def phases_engine(dev, smi: str) -> dict:
    """Phases W, N, M and A, each path's launches counted from zero.
    Returns the counts by path."""
    from robseg_torch import kernels
    with timed("W worst case"):
        phase_worst_case()
    bundle = build_model(dev)
    with timed("N norms"):
        kernels.reset_launch_counts()
        phase_norms(dev, bundle.logits_fn, smi)
        norms_counts = kernels.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with timed("M msf"):
            msf_counts = phase_msf(dev, tmp, bundle.logits_fn, smi)
        del bundle
        torch.cuda.empty_cache()
        with timed("A ADE20K train"):
            ade_counts = phase_ade_train(dev, tmp, smi)
    return {"norms": norms_counts, "msf": msf_counts,
            "ade-train": ade_counts}


# the data-parallel path (phase D): the train ranks run the block pair and
# the confusion kernel (their eval step), the --shard SEA CLI's ranks the
# block pair, the APGD-step and the confusion kernels
DP_PATH = ("convnext_block_fwd", "convnext_block_dx", "apgd_linf_step",
           "confusion_matrix")
DP_TIMED = 2
# each rank's first loss on its shard (before the mean over the ranks)
# against a one-rank step on that shard with that rank's draws: the same
# images, weights and draws at the same per-rank batch
DP_SHARD_LOSS_RTOL = 1e-4
# the mean first loss against 10a's one-card step at the whole batch: each
# rank normalises its BatchNorms over its own images and draws its own
# DropPath masks and random start (9.6e-4 measured on 2 ranks over gloo)
DP_FIRST_LOSS_RTOL = 1e-2
# the --shard SEA CLI's metrics against the unsharded one's: another
# per-rank batch, so other cuDNN kernels under TF32 (measured within
# 1.25e-04 on 2 ranks over gloo, 1.51e-05 on 4 over NCCL). Its per-image
# results are held to their own predictions and labels (each gathered row
# is its image's), not to the unsharded run's: the attack's sign steps
# carry those rounding differences into other adversarial images, whose
# union counts differ by up to 14% of an image's pixels
DP_SEA_ATOL = 1e-3


def dp_worlds(n_cards: int) -> list:
    """(ranks, backend) of phase D's worlds: one rank over NCCL, then 2
    ranks (and 4) over NCCL, one card each, or, with one card, 2 ranks
    sharing it over gloo."""
    worlds = [(1, "nccl")]
    worlds += [(n, "nccl") for n in (2, 4) if n <= n_cards]
    if n_cards < 2:
        worlds.append((2, "gloo"))
    return worlds


def record_local_loss(trainer) -> list:
    """Wrap ``trainer.loss_fn``: each step's loss on this rank's shard,
    before the mean over the ranks, is appended to the list returned."""
    local, loss_fn = [], trainer.loss_fn

    def recorded(*args):
        loss = loss_fn(*args)
        local.append(loss.detach().clone())
        return loss
    trainer.loss_fn = recorded
    return local


def dp_reference_rank(group, sizes) -> dict:
    """Phase D's one-rank reference, in a world of one (this process,
    NCCL): for each rank r of a world of each size of ``sizes``, a fresh
    trainer's first step on r's shard of the global batch with r's draws
    (the trainer seeds its generator from the seed, the step and
    ``group.rank``). Returns those first losses by size."""
    import dataclasses
    dev = group.device
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    out = {}
    for size in sizes:
        per = TRAIN_BATCH // size
        out[size] = []
        for r in range(size):
            trainer = upernet_trainer(dev, True,
                                      group=dataclasses.replace(group,
                                                                rank=r))
            rows = slice(r * per, (r + 1) * per)
            out[size].append(float(trainer.train_step(x[rows], y[rows])))
            del trainer
    torch.cuda.empty_cache()
    return out


def dp_train_rank(group, timed_steps: int) -> dict:
    """A rank of phase D's train step: 10a's step (fused attack) on this
    rank's shard of the global batch of 32 (every rank draws the whole
    batch from the seed and slices it), 2 warm-up and ``timed_steps``
    timed steps, then an eval step on its shard of the first 8 images.
    Returns s/step, peak GiB, the losses, the parameters that did not
    move, a checksum of the parameters and the launch counts."""
    from robseg_torch import kernels
    from robseg_torch.infer import set_numerics
    from robseg_torch.parallel import all_mean_, shard_batch
    set_numerics()
    dev = group.device
    x, y = train_inputs(dev, TRAIN_BATCH, TRAIN_HW, N_CLS)
    x, y = shard_batch(x, group), shard_batch(y, group)
    trainer = upernet_trainer(dev, True, group=group)
    local = record_local_loss(trainer)
    m = trainer.module
    p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    kernels.reset_launch_counts()
    dt, peak, losses, timer = time_train_steps(trainer, x, y, 2, timed_steps)
    hist = trainer.eval_step(x[:8 // group.size], y[:8 // group.size],
                             torch.zeros((N_CLS, N_CLS), device=dev))
    counts = kernels.launch_counts()
    # the step's one collective alone: the flat mean of the gradients
    grads = [p.grad for p in m.parameters() if p.grad is not None]
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_mean_(grads, group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    if int(hist.sum()) != 8 * TRAIN_HW * TRAIN_HW:
        raise AssertionError("data-parallel eval step histogram does not "
                             "count every pixel of the 8 images")
    with torch.no_grad():
        digest = [float(p.double().sum()) for p in m.parameters()]
    return {"dt": dt, "peak": peak, "losses": losses, "counts": counts,
            "local": float(local[0]),
            "still": [n for n, p in m.named_parameters()
                      if torch.equal(p.detach(), p0[n])],
            "digest": digest, "timer": timer.summary(),
            "card": f"cuda:{dev.index}", "reduce_ms": sorted(reduce_ms)[1],
            "reduce_mb": sum(g.numel() * g.element_size()
                             for g in grads) / 2 ** 20}


def build_rank(group) -> tuple:
    """A rank of phase 1: the kernel library built into the checkout's
    ``_build/`` (every rank of the world at once, each in a private
    directory, then a rename), then one confusion-kernel launch on the
    rank's card, bit for bit against the CPU. Returns the library's path,
    whether this rank found it missing, and the check."""
    from robseg_torch import kernels
    from robseg_torch.kernels import _build
    from robseg_torch.ops.metrics import confusion_matrix
    fresh = not os.path.exists(_build.library_path())
    path = _build.build()
    g = torch.Generator(device=group.device).manual_seed(group.rank)
    y = torch.randint(-1, N_CLS, (2, 64, 64), device=group.device,
                      generator=g)
    p = torch.randint(0, N_CLS, (2, 64, 64), device=group.device,
                      generator=g)
    got = confusion_matrix(p, y, num_classes=N_CLS)
    want = confusion_matrix(p.cpu(), y.cpu(), num_classes=N_CLS)
    return (path, fresh, kernels.launch_counts()["confusion_matrix"] == 1
            and torch.equal(got.cpu(), want))


def phase_build() -> str:
    """1: the kernels built by a world of 2 ranks (``dp_worlds``' second
    world: NCCL with a card each, or gloo sharing one card) that start
    with the checkout's empty ``_build/`` and compile at once; each rank
    then launches the confusion kernel. This process then loads the one
    library. Returns its path."""
    from robseg_torch.kernels import _build
    from robseg_torch.parallel import spawn_world
    size, backend = dp_worlds(torch.cuda.device_count())[1]
    t0 = time.time()
    ranks = spawn_world(build_rank, size, device_type="cuda",
                        backend=backend, timeout_s=600)
    paths = {r[0] for r in ranks}
    if len(paths) != 1 or not all(r[2] for r in ranks):
        raise AssertionError(f"build world: {ranks}")
    path = _build.build()
    if path not in paths:
        raise AssertionError(f"build world made {paths}, not {path}")
    print(f"build: {time.time() - t0:.1f} s by {size} ranks ({backend}) at "
          f"once, {sum(r[1] for r in ranks)} of them finding no library "
          f"({os.path.relpath(path, REPO)}); each rank's confusion kernel "
          f"equal to the CPU's", flush=True)
    return path


def in_process_world(fn, *args) -> list:
    """``[fn(group)]`` on this process as a world of one rank over NCCL
    (no process to start)."""
    import torch.distributed as dist
    from robseg_torch.parallel import setup
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(d, "rendezvous"),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            return [fn(setup("cuda"), *args)]
        finally:
            dist.destroy_process_group()


def sea_cache(save_dir: str) -> dict:
    """The per-image results of a SEA CLI run, from its ``argmax-logs``
    files, by file: each image's aAcc (``accs``) and intersection and
    union counts as fractions of its pixels (``ints``, ``unis``);
    ``own``: their largest distance from the same numbers recomputed from
    the file's predictions and labels (0 when every row of the
    predictions is its image's); ``rolled``: the mean aAcc of each
    image's predictions against the next image's labels (what a row
    gathered into the wrong place reads)."""
    d = os.path.join(save_dir, "argmax-logs")
    out = {}
    for name in sorted(os.listdir(d)):
        with np.load(os.path.join(d, name)) as f:
            got = {k: f[k] for k in ("accs", "ints", "unis")}
            preds = f["preds"].astype(np.int64)
            tgts = f["targets"].astype(np.int64)
        n, k = got["ints"].shape
        px = float(preds[0].size)
        valid = tgts != -1

        def acc(p):
            return (((p == tgts) & valid).reshape(n, -1).sum(1)
                    / np.maximum(valid.reshape(n, -1).sum(1), 1))
        ints = np.stack([np.bincount(t[(p == t) & v], minlength=k)
                         for p, t, v in zip(preds, tgts, valid)])
        unis = np.stack([np.bincount(p[v], minlength=k)
                         + np.bincount(t[v], minlength=k)
                         for p, t, v in zip(preds, tgts, valid)]) - ints
        own = max(float(np.abs(acc(preds) - got["accs"]).max()),
                  float(np.abs(ints - got["ints"]).max()) / px,
                  float(np.abs(unis - got["unis"]).max()) / px)
        out[name] = {"accs": got["accs"], "ints": got["ints"] / px,
                     "unis": got["unis"] / px, "own": own,
                     "rolled": float(acc(np.roll(preds, 1, 0)).mean())}
    return out


def phase_data_parallel(tmp: str, smi: str, sea_ref: tuple,
                        one_card: tuple) -> dict:
    """D: the data-parallel path. The train step of 10a at a global batch
    of 32 on each world of ``dp_worlds`` after the first
    (``parallel.spawn_world``), each held against one-rank steps (a world
    of one over NCCL in this process, ``dp_reference_rank``): each rank's
    first loss on its shard within ``DP_SHARD_LOSS_RTOL`` of a one-rank
    step on that shard with that rank's draws; the mean first loss within
    ``DP_FIRST_LOSS_RTOL`` of 10a's one-card step (``one_card``: its
    s/step, peak and losses, world 1's numbers); every parameter moved,
    the replicas identical; s/step, images/s and peak memory per rank.
    Then the ``--shard`` SEA CLI under torchrun on the VOC fixture with
    the largest world's ranks, against phase 5's unsharded CLI
    (``sea_ref``: its JSONs and ``sea_cache``): every metric of the JSON
    within ``DP_SEA_ATOL``, as many images in each ``argmax-logs`` file,
    each image's aAcc and intersection/union counts equal to those of its
    own gathered predictions and labels, the per-image differences from
    the unsharded run printed; every adversarial batch inside its eps ball
    (``phase_cli``). Returns the path's
    launches, summed over every rank of every world."""
    from robseg_torch.parallel import spawn_world
    counts = {}

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
    worlds = dp_worlds(torch.cuda.device_count())[1:]
    t0 = time.time()
    refs = in_process_world(dp_reference_rank, [n for n, _ in worlds])[0]
    dt1, peak1, losses1 = one_card
    print(f"data-parallel train step, world 1: 10a's one-card step, "
          f"{dt1:.4f} s/step, {TRAIN_BATCH / dt1:.2f} train images/s, peak "
          f"{peak1:.2f} GiB; one-rank reference steps on each rank's shard "
          f"(NCCL world of one, {time.time() - t0:.1f} s): first losses "
          f"{refs} [{smi}]", flush=True)
    for size, backend in worlds:
        t0 = time.time()
        ranks = spawn_world(dp_train_rank, size, (DP_TIMED,),
                            device_type="cuda", backend=backend,
                            timeout_s=400)
        for r in ranks:
            add(r["counts"])
            if r["still"]:
                raise AssertionError(f"world {size} ({backend}): parameters "
                                     f"that did not move {r['still'][:5]}")
        if any(r["digest"] != ranks[0]["digest"] for r in ranks):
            raise AssertionError(f"world {size} ({backend}): the replicas "
                                 "differ after the steps")
        local = [r["local"] for r in ranks]
        shard_rel = [abs(a - b) / abs(b) for a, b in zip(local, refs[size])]
        # what a rank on another rank's shard would read: the check's reach
        other_rel = min(abs(a - b) / abs(b) for i, a in enumerate(local)
                        for j, b in enumerate(refs[size]) if i != j)
        if max(shard_rel) > DP_SHARD_LOSS_RTOL:
            raise AssertionError(f"world {size} ({backend}): first losses "
                                 f"by rank {local} against one-rank steps "
                                 f"on their shards {refs[size]}")
        dt = max(r["dt"] for r in ranks)
        losses = ranks[0]["losses"]
        mean_rel = abs(losses[0] - sum(local) / size) / abs(losses[0])
        rel = abs(losses[0] - losses1[0]) / abs(losses1[0])
        if rel > DP_FIRST_LOSS_RTOL or mean_rel > 1e-6:
            raise AssertionError(f"world {size} ({backend}): first loss "
                                 f"{losses[0]} (ranks' {local}) against the "
                                 f"one-card step's {losses1[0]}")
        print(f"data-parallel train step, world {size} ({backend}, cards "
              f"{sorted({r['card'] for r in ranks})}), UperNet-ConvNeXt-"
              f"T_CVST, global batch {TRAIN_BATCH} ({TRAIN_BATCH // size} a "
              f"rank), {TRAIN_HW}^2, AdamW, PGD-5 through the block kernels: "
              f"{dt:.4f} s/step, {TRAIN_BATCH / dt:.2f} train images/s "
              f"({DP_TIMED} timed steps after 2; slowest rank; StepTimer by "
              f"rank {[r['timer'] for r in ranks]}); peak by rank "
              f"{[round(r['peak'], 2) for r in ranks]} GiB; the gradient "
              f"all-reduce ({ranks[0]['reduce_mb']:.1f} MiB float32) alone "
              f"{max(r['reduce_ms'] for r in ranks):.1f} ms (median of 3, "
              f"slowest rank); losses {[round(v, 4) for v in losses]}; first "
              f"losses by rank {local}, against the one-rank steps on their "
              f"shards {max(shard_rel):.2e} (on another rank's shard "
              f"{other_rel:.2e}); mean first loss {rel:.2e} from the "
              f"one-card step's; every parameter moved, replicas identical; "
              f"{time.time() - t0:.1f} s with the ranks' start [{smi}]",
              flush=True)
    size, backend = worlds[-1]
    launch = ("-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(size))
    label = f"_shard{size}"
    cli_counts, results = phase_cli(
        tmp, launch=launch, flags=("--shard",), label=label,
        env={"ROBSEG_DIST_BACKEND": backend})
    add(cli_counts)
    sea_json, want_c = sea_ref
    diffs = []
    for got, want in zip(results, sea_json):
        diffs += [abs(got[k] - want[k]) for k in ("worst_Acc", "final_miou")]
        diffs += [abs(g - w) for g, w in zip(got["worst_Acc_indiv"],
                                             want["worst_Acc_indiv"])]
        diffs += [abs(g[k] - w[k]) for g, w in zip(
            got["loss-wise_stats"] + [got["clean"]],
            want["loss-wise_stats"] + [want["clean"]]) for k in w]
    got_c = sea_cache(cli_save_dir(tmp, label=label))
    if got_c.keys() != want_c.keys() or not got_c:
        raise AssertionError(f"--shard SEA argmax-logs {sorted(got_c)} "
                             f"against the unsharded {sorted(want_c)}")
    per_image = {k: 0.0 for k in ("accs", "ints", "unis")}
    for name, want in want_c.items():
        got = got_c[name]
        if got["accs"].shape != want["accs"].shape or got["own"] > 1e-6:
            raise AssertionError(
                f"--shard SEA {name}: {got['accs'].shape[0]} images "
                f"against {want['accs'].shape[0]}; its rows {got['own']} "
                "from their own predictions and labels")
        for k in per_image:
            per_image[k] = max(per_image[k],
                               float(np.abs(got[k] - want[k]).max()))
    if max(diffs) > DP_SEA_ATOL:
        raise AssertionError(f"--shard SEA JSON {results} against the "
                             f"unsharded {sea_json}")
    n_img = len(next(iter(want_c.values()))["accs"])
    print(f"--shard SEA CLI on {size} ranks ({backend}) against the "
          f"unsharded CLI (phase 5): largest metric difference "
          f"{max(diffs):.2e}; per image ({n_img} images x {len(want_c)} "
          f"losses), each gathered row against its own predictions and "
          f"labels {max(g['own'] for g in got_c.values()):.2e} (a row in "
          f"the wrong place would read an aAcc of "
          f"{min(g['rolled'] for g in got_c.values()):.4f}, its own "
          f"{max(float(g['accs'].max()) for g in got_c.values()):.4f}); "
          f"largest per-image difference from the unsharded run "
          + ", ".join(f"{k} {v:.2e}" for k, v in per_image.items())
          + f"; worst_Acc_indiv {results[0]['worst_Acc_indiv']} / "
          f"{sea_json[0]['worst_Acc_indiv']} [{smi}]", flush=True)
    return counts


@contextlib.contextmanager
def timed(name: str):
    """Print a phase's wall seconds when it ends."""
    t0 = time.time()
    yield
    print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)


def phases_sea(dev, results) -> dict:
    """Phases 2-9p: the kernels against their plain versions, the models,
    and the SEA paths, each path's launches counted from zero. Returns the
    counts by path and the JSONs of phase 5's ``default`` SEA CLI."""
    from robseg_torch import kernels
    bundle = build_model(dev)
    weights = bundle.module.state_dict()
    with strict_float32():
        with timed("2 kernels"):
            phase_kernels(dev, results, train_stage_shapes())
        with timed("2 fpn"):
            phase_fpn(dev, results)
        with timed("2 mlp"):
            phase_mlp(dev, results)
        with timed("2b bf16 kernels"):
            phase_bf16_kernels(dev, results)
        with timed("3 model"):
            phase_model(dev, bundle.logits_fn)
        with timed("3b fused model"):
            phase_fused_model(dev, weights)
        with timed("3c bf16 model"):
            phase_model(dev, fused_model(dev, weights, "bf16"),
                        label="bf16 model", atol=5e-2)
        with timed("3d families card vs CPU"):
            phase_family_vs_cpu(dev)

    # each path counted from zero: the main path (APGD and the SEA CLI),
    # the fused-variant path (APGD and its bench entry point), the bf16
    # path (APGD, the SEA CLI and the bench entry point with bf16), the
    # families' path (APGD on Segmenter and PSPNet, the SEA CLI on them)
    with timed("4 main path"):
        kernels.reset_launch_counts()
        phase_apgd(dev, bundle.logits_fn)
        main_counts = kernels.launch_counts()
        phase_profile(dev, bundle.logits_fn)
    with timed("4b fused-variant path"):
        fused_fn = fused_model(dev, weights, fused_mlp_mode="residual",
                               fused_head="pallas")
        kernels.reset_launch_counts()
        phase_apgd(dev, fused_fn, n_iter=10, label="fused-variant path")
        fused_counts = kernels.launch_counts()
        phase_profile(dev, fused_fn, label="fused-variant-path", tail=True)
        del fused_fn
    with timed("4c bf16 path"):
        bf16_fn = fused_model(dev, weights, "bf16")
        kernels.reset_launch_counts()
        phase_apgd(dev, bf16_fn, label="bf16 main path")
        bf16_counts = kernels.launch_counts()
        phase_profile(dev, bf16_fn, label="bf16 main-path")
    with tempfile.TemporaryDirectory() as tmp:
        with timed("5 SEA CLI"):
            for precision, counts in (("default", main_counts),
                                      ("bf16", bf16_counts)):
                cli_counts, cli_json = phase_cli(tmp, precision)
                for name, n in cli_counts.items():
                    counts[name] += n
                if precision == "default":  # phase D's reference
                    sea_ref = cli_json, sea_cache(cli_save_dir(tmp))
        with timed("6 bench_fused"):
            for modes, flags, counts in (
                    (("rs", "recompute_bf16", "head"), (), fused_counts),
                    (("head", "rs"), ("--bf16",), bf16_counts)):
                for name, n in phase_bench_fused(modes, flags).items():
                    counts[name] += n
        with timed("8 probe"):
            phase_probe(dev, tmp, {
                "strict": (bundle.logits_fn, strict_float32),
                "default": (bundle.logits_fn, contextlib.nullcontext),
                "bf16": (bf16_fn, contextlib.nullcontext)})
        del bundle, bf16_fn
        torch.cuda.empty_cache()
        with timed("9 families path"):
            kernels.reset_launch_counts()
            phase_family_rates(dev)
            families_counts = kernels.launch_counts()
            for cfg_name, fixture, precision in (
                    ("voc_pspnet.yaml", fixture_voc, "default"),
                    ("ade20k_segmenter.yaml", fixture_ade, "bf16")):
                for name, n in phase_cli(tmp, precision, cfg_name, fixture,
                                         eps=(4, 8))[0].items():
                    families_counts[name] += n
    with timed("9p families profiles"):
        phase_family_profiles(dev)
    torch.cuda.empty_cache()
    return {"main": main_counts, "fused-variant": fused_counts,
            "bf16": bf16_counts, "families": families_counts}, sea_ref


def phases_train(dev, smi: str):
    """Phase 10, the PIR-AT train path: 10t, then 10a-10d counted from
    zero (the train CLI's printed counts added). Returns its launch
    counts and 10a's steps by attack."""
    from robseg_torch import kernels
    with timed("10t twin vs plain"):
        phase_train_twin(dev)
    kernels.reset_launch_counts()
    with timed("10a train step"):
        steps = phase_train_step(dev, smi)
    with timed("10b train apgd"):
        phase_train_apgd(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with timed("10c train CLI"):
            cli_counts, sea_counts = phase_train_cli(tmp)
    with timed("10d train families"):
        phase_train_families(dev, smi)
    counts = kernels.launch_counts()
    for name, n in cli_counts.items():
        counts[name] += n
    print(f"SEA CLI on the trained best_model.pth, launches (not the train "
          f"path's): {sea_counts}", flush=True)
    return counts, steps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(2)
    from robseg_torch.infer import set_numerics

    dev = torch.device("cuda")
    set_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    with timed("1 build"):
        phase_build()

    results = {}
    paths, sea_ref = phases_sea(dev, results)
    train_counts, steps = phases_train(dev, smi)
    print(f"train-path launches: {train_counts}", flush=True)
    bf16_train = phases_bf16_train(dev, smi, steps)
    print(f"bf16-train-path launches: {bf16_train}", flush=True)
    engine = phases_engine(dev, smi)
    for label, counts in engine.items():
        print(f"{label}-path launches: {counts}", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, timed("D data parallel"):
        dp_counts = phase_data_parallel(tmp, smi, sea_ref,
                                        steps["fused attack"])
    print(f"data-parallel-path launches: {dp_counts}", flush=True)
    missing = [f"{k} (train path)" for k in TRAIN_PATH
               if train_counts[k] <= 0]
    missing += [f"{k} (bf16 train path)" for k in BF16_TRAIN_PATH
                if bf16_train[k] <= 0]
    missing += [f"{k} ({label} path)" for label, need in (
        ("norms", NORMS_PATH), ("msf", MSF_PATH),
        ("ade-train", ADE_TRAIN_PATH)) for k in need
        if engine[label][k] <= 0]
    missing += [f"{k} (data-parallel path)" for k in DP_PATH
                if dp_counts.get(k, 0) <= 0]
    for label, counts in paths.items():
        print(f"{label}-path launches: {counts}", flush=True)
    launches = {name: paths["main" if name in MAIN_PATH else
                            "fused-variant" if name in FUSED_PATH else
                            "bf16"][name] for name in REPLACES}
    missing += [k for k, n in launches.items() if n <= 0] + [
        f"{k} (families path)" for k in FAMILIES_PATH
        if paths["families"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **({"launches_families_path": paths["families"][name]}
            if name in FAMILIES_PATH else {}),
         **({"launches_train_path": train_counts[name]}
            if name in TRAIN_PATH else {}),
         **({"launches_bf16_train_path": bf16_train[name]}
            if name in BF16_TRAIN_PATH else {}),
         **{f"launches_{label.replace('-', '_')}_path": engine[label][name]
            for label, need in (("norms", NORMS_PATH), ("msf", MSF_PATH),
                                ("ade-train", ADE_TRAIN_PATH))
            if name in need},
         **({"launches_data_parallel_path": dp_counts[name]}
            if name in DP_PATH else {}),
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "stages", "modes",
                                          "cases")
            if k in results[name]}}
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
