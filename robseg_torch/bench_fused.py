"""A/B of the model's fused-kernel settings on the APGD attack path.

Counterpart of ``tools/bench_fused.py`` with the same flags, modes and JSON
keys. For UperNet-ConvNeXt-T_CVST (21 classes, seeded random weights) at
``--hw`` and ``--batch`` it measures, per mode:

  * ``fwd_full_{mode}_ms``: the full model's forward;
  * ``attack_step_imgs_per_s_{mode}``: APGD (mask-ce-avg, tracking ce-avg,
    random start) at ``--n_iter`` iterations, whole-run step*imgs/s;
  * ``attack_acc_{mode}``: the attacked mean pixel accuracy.

Modes: ``default`` (unfused blocks, concat bottleneck), ``head`` (FPN
concat-conv kernel), ``head_split``, ``block`` (the block kernel),
``block_head_split`` (the main path), ``block_head``, and the MLP-tail
kernels ``rs``, ``recompute``, ``rs_bf16``, ``recompute_bf16`` with the
concat bottleneck.

``--bf16`` runs every mode with bf16 parameters and activations (the
``--precision bf16`` model, ``ModelBundle(..., "bf16")``): the block and
FPN kernels in their bf16 I/O forms, the MLP-tail modes on bf16 inputs
upcast, with float32 after them (JAX's dtype trail). The forward timing
runs that same bf16 model (the JAX script times it on float32 input).
Numerics outside the kernels are the CLI's (``infer.set_numerics``): TF32
in cuBLAS and cuDNN.

    python -m robseg_torch.bench_fused [--modes default,rs] [--batch 16]

Runs on the CUDA card (``--device cpu`` for a small run on the CPU). The
last two lines are ``kernel launches: {...}`` and the JSON results.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_CLS = 21
# mode -> UperNetForSemanticSegmentation settings (tools/bench_fused.py:66-92)
MODES = {
    "default": dict(fused_mlp=False, fused_head=False),
    "head": dict(fused_mlp=False, fused_head=True),
    "head_split": dict(fused_mlp=False, fused_head="split"),
    "block_head_split": dict(fused_mlp_mode="block", fused_head="split"),
    "block_head": dict(fused_mlp_mode="block", fused_head=True),
    "rs": dict(fused_mlp_mode="residual", fused_head=False),
    "recompute": dict(fused_mlp_mode="recompute", fused_head=False),
    "rs_bf16": dict(fused_mlp_mode="residual_bf16", fused_head=False),
    "recompute_bf16": dict(fused_mlp_mode="recompute_bf16",
                           fused_head=False),
    "block": dict(fused_mlp_mode="block", fused_head=False),
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--hw", type=int, default=512)
    parser.add_argument("--n_iter", type=int, default=20)
    parser.add_argument("--modes", type=str, default="default,rs")
    parser.add_argument("--skip_backbone", action="store_true")
    parser.add_argument("--bf16", action="store_true",
                        help="full-bf16 params and activations (the "
                             "--precision bf16 production mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    bad = [m for m in args.modes.split(",") if m not in MODES]
    if bad:
        parser.error(f"unknown modes {bad}; choose from {sorted(MODES)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available (pass "
                     "--device cpu to run on the CPU)")
    return args


def main(argv=None):
    args = parse_args(argv)
    from robseg_torch import kernels
    from robseg_torch.attacks.apgd import apgd_attack
    from robseg_torch.infer import set_numerics
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation

    precision = "bf16" if args.bf16 else "default"
    set_numerics()
    dev = torch.device(args.device)
    batch, hw = args.batch, args.hw
    rng = np.random.default_rng(0)
    x = torch.tensor(np.ascontiguousarray(
        np.moveaxis(rng.random((batch, hw, hw, 3)), -1, 1)),
        dtype=torch.float32, device=dev)
    y = torch.tensor(rng.integers(0, N_CLS, (batch, hw, hw)), device=dev)
    torch.manual_seed(0)
    weights = UperNetForSemanticSegmentation(
        "T_CVST", N_CLS, fused_mlp=False, fused_head=False).state_dict()

    def make(mode):
        m = UperNetForSemanticSegmentation("T_CVST", N_CLS, **MODES[mode])
        m.load_state_dict(weights, strict=True)
        return ModelBundle(m.to(dev), precision).logits_fn

    def ready():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def time_call(fn, reps):
        fn()
        ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ready()
        return (time.perf_counter() - t0) / reps

    results = {}
    modes = args.modes.split(",")
    kernels.reset_launch_counts()
    if not args.skip_backbone:
        for mode in modes + (["recompute"] if "recompute" not in modes
                             else []):
            fn = make(mode)
            with torch.no_grad():
                dt = time_call(lambda: fn(x).mean(), reps=10)
            results[f"fwd_full_{mode}_ms"] = round(dt * 1000, 1)
            print(f"full fwd {mode}: {dt * 1000:.1f} ms", flush=True)

    for mode in modes:
        fn = make(mode)

        def run():
            res = apgd_attack(fn, x, y, norm="Linf", eps=8 / 255,
                              n_iter=args.n_iter, use_rs=True,
                              loss="mask-ce-avg", track_loss="ce-avg",
                              generator=torch.Generator(dev).manual_seed(1))
            res.acc.cpu()  # waits for the device
            return res

        print(f"first attack run ({mode})...", flush=True)
        t0 = time.perf_counter()
        res = run()
        print(f"  run {time.perf_counter() - t0:.0f}s", flush=True)
        acc = float(res.acc.float().mean())
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        dt = (time.perf_counter() - t0) / reps
        rate = args.n_iter * batch / dt
        results[f"attack_step_imgs_per_s_{mode}"] = round(rate, 1)
        results[f"attack_acc_{mode}"] = round(acc, 5)
        print(f"attack {mode}: {rate:.1f} step*imgs/s  acc={acc:.5f}",
              flush=True)

    print("kernel launches: " + json.dumps(kernels.launch_counts()))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
