"""SEA evaluation CLI of the port.

Counterpart of ``tools/infer.py``: config-driven model build and checkpoint
load, the clean evaluation, the three-loss SEA at ``--n_iter`` APGD
iterations per loss, per-attack stats and the worst-case aggregation, with
the same output files under ``SAVE_DIR`` (``worse_SEA_*.json``,
``sea-stats/``, ``argmax-logs/``) and the same log lines.

Usage:
    python -m robseg_torch.infer --cfg configs/pascalvoc_convnext.yaml --eps 8

The config's ``DEVICE`` picks the device (``tpu``/``gpu``/``cuda`` -> the
CUDA card, ``cpu`` -> the CPU). On CUDA the hand-written kernels always
run. ``--precision`` (``PRECISION_HELP``): ``default`` runs float32 with
TF32 in cuBLAS and cuDNN, the reference's numerics class; ``bf16`` casts
parameters and activations to bf16; ``f32`` is refused, as the JAX CLI
refuses it with its block kernel. On exit the CLI prints one ``kernel
launches: {...}`` JSON line with each kernel's launch count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from robseg_torch import kernels
from robseg_torch.attacks.sea import SEA_LOSSES, eval_performance, run_sea
from robseg_torch.config import (dataset_eval_geometry, load_config,
                                 model_display_name, resolve_device)
from robseg_torch.data import get_segmentation_dataset, simple_eval_loader
from robseg_torch.models import ModelBundle, build_model
from robseg_torch.utils import Logger, class_balance_weights

SEED = 225  # parity: tools/infer.py:25

_REFUSED = {
    "msf": "multi-scale + flip evaluation (utils/sliding_window.py)",
    "shard": "sharded SEA across devices",
    "fused": "--fused (the port's kernels are always on under CUDA)",
}
PRECISION_HELP = (
    "default: float32 parameters and activations, cuBLAS and cuDNN in TF32 "
    "(the numerics class of the JAX package's default: XLA's default "
    "precision, which is TF32 on this card and bf16 passes on a TPU); the "
    "block kernel rounds its matmul operands to bf16, as the TPU kernel "
    "does. bf16: bf16 parameters and activations (the block and FPN kernels "
    "in their bf16 I/O forms), float32 logits, loss and attack. f32: "
    "refused, see its error")
F32_REFUSED = (
    "--precision f32: the ConvNeXt block kernel rounds its matmul operands "
    "to bf16 (XLA-DEFAULT numerics, as the TPU kernel does) and cannot "
    "honor --precision f32; use --precision default (same numerics class)")


def set_numerics() -> None:
    """The reference's numerics class outside the kernels: TF32 in cuBLAS
    matmuls and cuDNN convolutions, under ``default`` and ``bf16`` alike
    (what XLA does with float32 at its default precision on this card).
    The kernels do not read these flags."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def load_weights(module: torch.nn.Module, ckpt_path: str) -> None:
    """A reference PyTorch ``.pth`` state_dict loads directly (strict)."""
    if str(ckpt_path).endswith(".npz"):
        raise NotImplementedError(
            ".npz (JAX) checkpoints: convert them with "
            "robseg_torch.convert.upernet_state_dict_from_jax and save a "
            ".pth; direct .npz loading is a later slice (ROADMAP.md)")
    sd = torch.load(ckpt_path, map_location="cpu")
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--eps", type=str, default="8",
                        help="epsilon in /255 units; comma list for a "
                             "multi-eps sweep (e.g. '4,8')")
    parser.add_argument("--n_iter", type=int, default=300)
    parser.add_argument("--n_batches", type=int, default=-1)
    parser.add_argument("--adversarial", action="store_true", default=True)
    parser.add_argument("--no-adversarial", dest="adversarial",
                        action="store_false")
    parser.add_argument("--ckpt", type=str, default=None,
                        help=".pth state_dict (overrides EVAL.MODEL_PATH)")
    parser.add_argument("--precision", type=str, default="default",
                        choices=["default", "bf16", "f32"],
                        help=PRECISION_HELP)
    parser.add_argument("--cleanup", action="store_true",
                        help="delete the argmax-logs resume cache after a "
                             "completed sweep")
    parser.add_argument("--wc_engine", type=str, default="python",
                        choices=["auto", "python", "native", "reference",
                                 "reference-python"],
                        help="worst-case-mIoU search engine (only 'python' "
                             "is ported; 'auto' means 'python')")
    for flag in _REFUSED:
        parser.add_argument(f"--{flag}", action="store_true",
                            help="not ported yet")
    args = parser.parse_args(argv)
    for flag, what in _REFUSED.items():
        if getattr(args, flag):
            parser.error(f"--{flag}: {what} is not ported to robseg_torch "
                         "yet; it is a later slice of the port (ROADMAP.md)")
    if args.precision == "f32":
        parser.error(F32_REFUSED)
    return args


def main(argv=None):
    args = parse_args(argv)
    set_numerics()
    cfg = load_config(args.cfg)
    device = resolve_device(cfg)
    dataset_cfg, test_cfg = cfg["DATASET"], cfg["EVAL"]
    n_cls = test_cfg["N_CLS"]
    _, crop_size = dataset_eval_geometry(test_cfg["NAME"])

    np.random.seed(SEED)
    torch.manual_seed(SEED)
    backbone = test_cfg.get("BACKBONE", cfg["MODEL"].get("BACKBONE"))
    module = build_model(cfg["MODEL"]["NAME"], backbone, n_cls)
    ckpt_path = args.ckpt or test_cfg.get("MODEL_PATH")
    if ckpt_path and os.path.exists(str(ckpt_path)):
        load_weights(module, ckpt_path)
    else:
        print(f"WARNING: no checkpoint at {ckpt_path!r}; "
              "evaluating random init")
    logits_fn = ModelBundle(module.to(device), args.precision).logits_fn

    ds = get_segmentation_dataset(test_cfg["NAME"], root=dataset_cfg["ROOT"],
                                  split="val", crop_size=crop_size)
    bs = test_cfg.get("BATCH_SIZE", 4)
    make_loader = lambda: simple_eval_loader(ds, bs, args.n_batches)  # noqa

    weights = class_balance_weights(test_cfg["NAME"])
    save_dir = str(cfg.get("SAVE_DIR", "./outputs"))
    os.makedirs(save_dir, exist_ok=True)
    logger = Logger(os.path.join(save_dir, "sea_eval_log.txt"))

    def cleanup_cache():
        if not args.cleanup:
            return
        cache_dir = os.path.join(save_dir, "argmax-logs")
        if os.path.isdir(cache_dir):
            shutil.rmtree(cache_dir)
            logger.log(f"--cleanup: removed resume cache {cache_dir}")

    modelname = model_display_name(cfg["MODEL"]["NAME"],
                                   test_cfg.get("BACKBONE", ""))
    eps_list = [float(e) for e in str(args.eps).split(",")]
    logger.log(f"Model > {modelname}; Dataset > {test_cfg['NAME']}; "
               f"eps sweep = {eps_list} (/255), n_iter = {args.n_iter}")

    if not args.adversarial:
        stats, _ = eval_performance(logits_fn, make_loader(),
                                    num_classes=n_cls,
                                    n_batches=args.n_batches, device=device)
        logger.log(f"Clean performance: {stats.as_dict()}")
        cleanup_cache()
        _log_launches(logger)
        return

    stats_dir = os.path.join(save_dir, "sea-stats")
    os.makedirs(stats_dir, exist_ok=True)
    # resume caches are keyed to the checkpoint identity (stale-proof)
    if ckpt_path and os.path.exists(str(ckpt_path)):
        cache_tag = (os.path.basename(str(ckpt_path)).replace(".", "-")
                     + f"-{int(os.path.getmtime(str(ckpt_path)))}")
    else:
        cache_tag = "randominit"
    for eps in eps_list:
        results = run_sea(logits_fn, make_loader, num_classes=n_cls,
                          eps=eps / 255.0, n_iter=args.n_iter,
                          weights=weights, n_batches=args.n_batches,
                          seed=SEED, verbose=True, cache_tag=cache_tag,
                          wc_engine=args.wc_engine, device=device,
                          resume_dir=os.path.join(save_dir, "argmax-logs"))
        logger.log(json.dumps(results, indent=2, default=float))
        # per-attack text reports; parity: writeIndivloss
        # (semseg/utils/utils.py:236-245)
        for loss_name, st in zip(SEA_LOSSES, results["loss-wise_stats"]):
            with open(os.path.join(
                    stats_dir,
                    f"loss_wise_{modelname}_{loss_name}_N_{eps}.txt"),
                    "a+") as f:
                f.write(f"{modelname}\n")
                f.write(f"Clean stats: {results['clean']}\n")
                f.write(f"----- Linf radius: {eps} ------")
                f.write(f"Attack: {loss_name}\n")
                f.write(f"Adversarial results: {st}\n")
        out_path = os.path.join(
            save_dir, f"worse_SEA_{modelname}_{test_cfg['NAME']}_{eps}.json")
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2, default=float)
        logger.log(f"SEA statistics at: {out_path}")

    # every eps in the sweep completed: safe to drop the resume cache
    cleanup_cache()
    _log_launches(logger)


def _log_launches(logger: Logger) -> None:
    logger.log("kernel launches: " + json.dumps(kernels.launch_counts()))


if __name__ == "__main__":
    main()
