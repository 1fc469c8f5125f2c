"""SEA evaluation CLI of the port.

Counterpart of ``tools/infer.py``: config-driven model build and checkpoint
load, the clean evaluation, the three-loss SEA at ``--n_iter`` APGD
iterations per loss, per-attack stats and the worst-case aggregation, with
the same output files under ``SAVE_DIR`` (``worse_SEA_*.json``,
``sea-stats/``, ``argmax-logs/``) and the same log lines.

Usage:
    python -m robseg_torch.infer --cfg configs/pascalvoc_convnext.yaml --eps 8
    torchrun --nproc_per_node N -m robseg_torch.infer --cfg ... --shard

``--shard`` under ``torchrun`` splits each SEA batch over the ranks, one
process a card (``parallel/mesh.py``; the JAX CLI's ``--shard`` over its
mesh, ``tools/infer.py:220-227``): per-image results equal the one-card
run's, and only rank 0 logs and writes the output files. Without
``torchrun``'s environment (or with ``WORLD_SIZE`` 1) ``--shard`` is the
one-card run; under ``torchrun`` without ``--shard`` the CLI refuses to
start, as every rank would run the whole evaluation.

The config's ``DEVICE`` picks the device (``tpu``/``gpu``/``cuda`` -> the
CUDA card, ``cpu`` -> the CPU). On CUDA the hand-written kernels always
run. ``--precision`` (``PRECISION_HELP``): ``default`` runs float32 with
TF32 in cuBLAS and cuDNN, the reference's numerics class; ``bf16`` casts
parameters and activations to bf16; ``f32`` is refused, as the JAX CLI
refuses it with its block kernel. ``--no-adversarial --msf`` evaluates the
clean model over scales (0.5, 0.75, 1.0, 1.25, 1.5) and their flips
(``utils/sliding_window.py``). ``--wc_engine`` defaults to ``auto``, the
C++ engine, as in the JAX CLI. On exit the CLI prints one ``kernel
launches: {...}`` JSON line with each kernel's launch count (summed over
the ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from robseg_torch import kernels
from robseg_torch.attacks.sea import SEA_LOSSES, eval_performance, run_sea
from robseg_torch.attacks.worst_case import ENGINES
from robseg_torch.config import (dataset_eval_geometry, load_config,
                                 model_display_name, resolve_device)
from robseg_torch.convert import npz_state_dict
from robseg_torch.data import get_segmentation_dataset, simple_eval_loader
from robseg_torch.models import ModelBundle, build_model
from robseg_torch.models.vit import resize_pos_embed
from robseg_torch.parallel import (barrier, gather_objects, is_main,
                                   replicate, setup, teardown)
from robseg_torch.utils import Logger, class_balance_weights, fix_seeds
from robseg_torch.utils.sliding_window import multi_scale_flip_logits

SEED = 225  # parity: tools/infer.py:25

MSF_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5)  # tools/infer.py:195
# flags of the JAX CLI that have no meaning here, with the reason
_REFUSED = {
    "fused": "--fused turns the JAX package's Pallas block kernel on; "
             "under CUDA the port's kernels are always on, so there is "
             "nothing to turn on",
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


# the models whose reference .pth the JAX CLI converts (tools/infer.py:
# convert_upernet, convert_pspnet, convert_segmenter); it sends the other
# three names to convert_segmenter, which cannot read them
PTH_MODELS = ("UperNetForSemanticSegmentation", "PSPNet", "SegMenter")


def build_eval_model(cfg, n_cls: int, crop_size) -> torch.nn.Module:
    """The config's model, as ``tools/infer.py::build_eval_model`` builds
    it: the crop size is the Segmenter's native grid, PSPNet has the
    deep-base stem."""
    backbone = cfg["EVAL"].get("BACKBONE", cfg["MODEL"].get("BACKBONE"))
    return build_model(cfg["MODEL"]["NAME"], backbone, n_cls,
                       image_size=crop_size)


def load_weights(module: torch.nn.Module, ckpt_path: str,
                 model_name: str = "UperNetForSemanticSegmentation",
                 backbone: str = "ConvNeXt-T_CVST") -> None:
    """A reference PyTorch ``.pth`` state_dict loads directly (strict), with
    the ``module.`` / ``base_model.`` prefixes stripped as the JAX
    converters strip them; a Segmenter's position embedding is resampled
    to the model's native grid, as ``convert_vit_encoder`` does. A JAX
    trainer's ``.npz`` (with its ``.stats.npz`` BatchNorm statistics
    beside it) goes through ``convert/from_jax.py::npz_state_dict``, as
    ``tools/infer.py:120-124`` reads it."""
    if str(ckpt_path).endswith(".npz"):
        module.load_state_dict(npz_state_dict(ckpt_path, model_name,
                                              backbone), strict=True)
        return
    if model_name not in PTH_MODELS:
        raise ValueError(
            f"{model_name}: no .pth loader. The JAX package converts "
            f"reference checkpoints of {', '.join(PTH_MODELS)} only (its CLI "
            "hands this name to convert_segmenter, which cannot read it), "
            "and the port adds none")
    sd = torch.load(ckpt_path, map_location="cpu")
    sd = {k.replace("module.", "").replace("base_model.", ""): v
          for k, v in sd.items()}
    pos = sd.get("encoder.pos_embed")
    if pos is not None and pos.shape != module.encoder.pos_embed.shape:
        sd["encoder.pos_embed"] = resize_pos_embed(
            pos, None, module.encoder.native_grid, module.encoder.num_extra)
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
    parser.add_argument("--msf", action="store_true",
                        help="multi-scale + flip clean eval "
                             "(with --no-adversarial)")
    parser.add_argument("--shard", action="store_true",
                        help="under torchrun: split each batch over the "
                             "ranks, one process a card (per-image results "
                             "identical); without torchrun the one-card "
                             "run")
    parser.add_argument("--ckpt", type=str, default=None,
                        help=".pth state_dict or JAX .npz params "
                             "(overrides EVAL.MODEL_PATH)")
    parser.add_argument("--precision", type=str, default="default",
                        choices=["default", "bf16", "f32"],
                        help=PRECISION_HELP)
    parser.add_argument("--cleanup", action="store_true",
                        help="delete the argmax-logs resume cache after a "
                             "completed sweep")
    parser.add_argument("--wc_engine", type=str, default="auto",
                        choices=list(ENGINES),
                        help="worst-case-mIoU search engine; 'auto' is "
                             "'native' (C++, built with g++ at first use; "
                             "a failed build raises), 'reference' "
                             "replicates the published code's class-list-"
                             "shrink quirk (worse_only.py:79-93)")
    for flag in _REFUSED:
        parser.add_argument(f"--{flag}", action="store_true",
                            help="refused, see its error")
    args = parser.parse_args(argv)
    for flag, why in _REFUSED.items():
        if getattr(args, flag):
            parser.error(why)
    if args.precision == "f32":
        parser.error(F32_REFUSED)
    if not args.shard and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        parser.error("launched on several ranks without --shard: every rank "
                     "would run the whole evaluation")
    return args


def main(argv=None):
    args = parse_args(argv)
    set_numerics()
    cfg = load_config(args.cfg)
    device = resolve_device(cfg)
    group = setup(device.type) if args.shard else None
    try:
        evaluate_cli(args, cfg, device if group is None else group.device,
                     group)
    finally:
        teardown(group)


def evaluate_cli(args, cfg, device, group):
    """``main`` once the device and the world are set: the clean or SEA
    evaluation, split over ``group``'s ranks (or alone)."""
    main_rank = is_main(group)
    dataset_cfg, test_cfg = cfg["DATASET"], cfg["EVAL"]
    n_cls = test_cfg["N_CLS"]
    _, crop_size = dataset_eval_geometry(test_cfg["NAME"])

    fix_seeds(SEED)
    module = build_eval_model(cfg, n_cls, crop_size)
    ckpt_path = args.ckpt or test_cfg.get("MODEL_PATH")
    if ckpt_path and os.path.exists(str(ckpt_path)):
        load_weights(module, ckpt_path, cfg["MODEL"]["NAME"],
                     test_cfg.get("BACKBONE", cfg["MODEL"].get("BACKBONE")))
    elif main_rank:
        print(f"WARNING: no checkpoint at {ckpt_path!r}; "
              "evaluating random init")
    module.to(device)
    replicate(module, group)  # rank 0's weights, whatever the other disks
    logits_fn = ModelBundle(module, args.precision).logits_fn

    ds = get_segmentation_dataset(test_cfg["NAME"], root=dataset_cfg["ROOT"],
                                  split="val", crop_size=crop_size)
    bs = test_cfg.get("BATCH_SIZE", 4)
    make_loader = lambda: simple_eval_loader(ds, bs, args.n_batches)  # noqa

    weights = class_balance_weights(test_cfg["NAME"])
    save_dir = str(cfg.get("SAVE_DIR", "./outputs"))
    os.makedirs(save_dir, exist_ok=True)
    logger = Logger(os.path.join(save_dir, "sea_eval_log.txt") if main_rank
                    else None, quiet=not main_rank)

    def cleanup_cache():
        if not args.cleanup:
            return
        barrier(group)  # no rank reads the cache any more
        cache_dir = os.path.join(save_dir, "argmax-logs")
        if main_rank and os.path.isdir(cache_dir):
            shutil.rmtree(cache_dir)
            logger.log(f"--cleanup: removed resume cache {cache_dir}")

    modelname = model_display_name(cfg["MODEL"]["NAME"],
                                   test_cfg.get("BACKBONE", ""))
    eps_list = [float(e) for e in str(args.eps).split(",")]
    logger.log(f"Model > {modelname}; Dataset > {test_cfg['NAME']}; "
               f"eps sweep = {eps_list} (/255), n_iter = {args.n_iter}")

    if not args.adversarial:
        if args.msf:
            # multi-scale + flip clean eval; parity: semseg/val.py:329-374
            msf_fn = lambda x: multi_scale_flip_logits(  # noqa: E731
                logits_fn, x, scales=MSF_SCALES, flip=True,
                num_classes=n_cls)
            stats, _ = eval_performance(msf_fn, make_loader(),
                                        num_classes=n_cls,
                                        n_batches=args.n_batches,
                                        device=device, group=group,
                                        return_preds=False)
            logger.log(f"MSF clean performance: {stats.as_dict()}")
        else:
            stats, _ = eval_performance(logits_fn, make_loader(),
                                        num_classes=n_cls,
                                        n_batches=args.n_batches,
                                        device=device, group=group,
                                        return_preds=False)
            logger.log(f"Clean performance: {stats.as_dict()}")
        cleanup_cache()
        _log_launches(logger, group)
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
                          resume_dir=os.path.join(save_dir, "argmax-logs"),
                          group=group)
        logger.log(json.dumps(results, indent=2, default=float))
        if not main_rank:
            continue
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
    _log_launches(logger, group)


def _log_launches(logger: Logger, group) -> None:
    """Each kernel's launches, summed over the ranks (and by rank under
    a group)."""
    counts = gather_objects(kernels.launch_counts(), group)
    logger.log("kernel launches: " + json.dumps(
        {k: sum(c[k] for c in counts) for k in counts[0]}))
    if group is not None:
        logger.log("kernel launches by rank: " + json.dumps(counts))


if __name__ == "__main__":
    main()
