"""PIR-AT training CLI of the port, on one card or data-parallel over
several.

Counterpart of ``tools/train.py`` (reference ``tools/train_rob_seg.py``):
config-driven model, optimizer and schedule per family, PIR init from
``MODEL.PRETRAINED``, iteration-based adversarial training, a log line
every half epoch, eval and checkpoint every ``EVAL_FREQ`` epochs on
``EVAL_BATCHES`` val batches (the tail batch padded with ignore labels),
best-mIoU tracking that survives ``--resume``, and at the end a reload of
the best weights and an eval on the whole val split. Weights are written
as reference-layout ``best_model.pth`` / ``final_model.pth``, which
``python -m robseg_torch.infer --ckpt`` reads; the resume state goes to
``ckpts/``.

Usage:
    python -m robseg_torch.train --cfg configs/pascalvoc_convnext.yaml \
        [--max_iters N] [--resume --run_dir DIR] [--fused_attack] \
        [--precision default|bf16|f32]
    torchrun --nproc_per_node N -m robseg_torch.train --cfg ... [--multihost]

Under ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_*`` environment) the run is data-parallel, one process a card
(``parallel/mesh.py``; NCCL, or gloo with ``DEVICE: cpu``): each rank
trains on ``TRAIN.BATCH_SIZE // world`` images of the global batch, the
ones its shard of the ``ShardedEpochSampler`` holds (``tools/train.py:
103-119``); gradients, the loss and BatchNorm running statistics are
averaged over the ranks (``train/trainer.py``); evaluations shard the
eval batch and sum the confusion matrices. Only rank 0 logs and writes
checkpoints and weights, then the ranks meet at a barrier; every
decision that reads a file (``--resume``'s checkpoint and best-so-far, the
last checkpoint, the best weights' reload) is rank 0's, its data sent to
every rank, so the ranks of ``--multihost`` (several machines, ``torchrun
--nnodes``, which requires that environment) need no shared disk.
Without it the run is the one-card run.

Precision as the JAX CLI resolves it (``tools/train.py:98-111``):
``default`` trains in float32 with TF32 in cuBLAS and cuDNN; ``bf16``,
or ``TRAIN.AMP: true`` under ``default``, in bf16 products
(``ops/precision.py``: every product of the models takes bf16-rounded
operands and accumulates in float32; parameters, optimizer state, norms
and losses stay float32; the kernels are unchanged), around the whole
run; ``f32`` in float32 with TF32 off, ``TRAIN.AMP`` ignored.

The config's ``DEVICE`` picks the device (``tpu``/``gpu``/``cuda`` -> the
CUDA card, rank r's ``cuda:{LOCAL_RANK}``; ``cpu`` -> the CPU; no
fallback). ``--fused_attack`` (UperNet)
makes the adversarial examples through the block kernels' twin of the
model; the update always differentiates the plain module. On exit the CLI
prints one ``kernel launches: {...}`` JSON line.

``TRAIN.DEVICE_AUG: true`` (``tools/train.py:247-283``): the host loads
raw images into ``2 * BASE_SIZE`` square buffers (``load_raw_batch``, the
``ShardedEpochSampler``'s indices, through ``prefetch``) and
``augment_batch`` flips, scales, pads, blurs and crops them on the card;
the batch stays there. Its draws come from a ``torch.Generator`` seeded
with ``SEED + 7`` at every start, as the JAX CLI seeds its key (under
data parallelism a generator a rank, seeded from ``SEED + 7`` and the
rank), so a resumed run does not continue the draws; the batches of an
epoch already trained are skipped on resume, as on the host path.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from robseg_torch import kernels
from robseg_torch.config import TrainSettings, load_config, resolve_device
from robseg_torch.convert import load_pir
from robseg_torch.data import (IterationBasedLoader, ShardedEpochSampler,
                               get_segmentation_dataset, prefetch,
                               simple_eval_loader)
from robseg_torch.data.device_transforms import augment_batch, load_raw_batch
from robseg_torch.infer import set_numerics
from robseg_torch.models import build_model
from robseg_torch.ops.precision import bf16_products
from robseg_torch.parallel import (RENDEZVOUS_ENV, barrier,
                                   broadcast_object, fold_seed,
                                   gather_objects, is_main, replicate, setup,
                                   shard_batch, teardown, world_size)
from robseg_torch.train.checkpoint import CheckpointManager, save_weights
from robseg_torch.train.optim import (freeze_mask, make_optimizer,
                                      pspnet_lr_scales)
from robseg_torch.train.schedules import (get_scheduler, poly_lr,
                                          polynomial_lr_timm)
from robseg_torch.train.trainer import (AttackConfig, Trainer,
                                        metrics_from_hist)
from robseg_torch.utils import Logger

UPERNET = "UperNetForSemanticSegmentation"
PRECISION_LOG = {
    "bf16": "bf16 products (float32 parameters and accumulation, every "
            "product's operands rounded to bf16)",
    "default": "float32, TF32 in cuBLAS and cuDNN",
    "f32": "float32, TF32 off",
}


def resolve_precision(flag: str, amp: bool) -> str:
    """The precision a run trains in, ``tools/train.py:98-111``:
    ``--precision bf16`` means bf16 products, and so does ``TRAIN.AMP``
    under ``default``; ``f32`` ignores ``TRAIN.AMP``."""
    return "bf16" if flag == "bf16" or (flag == "default" and amp) \
        else flag


def build_optimizer(cfg, model_name, module, max_iters, iters_per_epoch,
                    frozen_mask=None):
    """Per-family optimizer and schedule, ``tools/train.py:45-73``:
    Segmenter timm SGD + polynomial; PSPNet SGD + poly with the new
    modules at x10; UperNet the config's optimizer and scheduler."""
    opt_cfg, sched_cfg = cfg["OPTIMIZER"], cfg["SCHEDULER"]
    lr = float(opt_cfg["LR"])
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.01))
    if model_name == "SegMenter":
        sched = polynomial_lr_timm(1e-3, max_iters, power=0.9,
                                   iter_warmup=0, min_lr=1e-5)
        return make_optimizer("sgd", module, sched, weight_decay=1e-5,
                              frozen_mask=frozen_mask), sched
    if model_name == "PSPNet":
        sched = poly_lr(lr, max_iters, power=0.9)
        return make_optimizer("sgd", module, sched, weight_decay=wd,
                              lr_scales=pspnet_lr_scales(module),
                              frozen_mask=frozen_mask), sched
    sched = get_scheduler(
        sched_cfg["NAME"], lr, max_iters, sched_cfg.get("POWER", 0.9),
        iters_per_epoch * sched_cfg.get("WARMUP", 5),
        sched_cfg.get("WARMUP_RATIO", 1e-5))
    return make_optimizer(opt_cfg.get("NAME", "AdamW"), module, sched,
                          weight_decay=wd, frozen_mask=frozen_mask), sched


def raw_batches(dataset, *, batch_size: int, max_iters: int, seed: int,
                start_iter: int, buffer: int, num_shards: int = 1,
                host_id: int = 0):
    """``load_raw_batch`` buffers (``buffer`` square) for the iterations
    ``start_iter`` to ``max_iters``, in the ``ShardedEpochSampler``'s
    order, the last partial batch of an epoch dropped: ``batch_size``
    images of shard ``host_id`` of ``num_shards`` (one shard a rank)."""
    sampler = ShardedEpochSampler(len(dataset), num_shards, seed=seed,
                                  num_hosts=num_shards, host_id=host_id)
    per_epoch = max(sampler.num_samples // batch_size, 1)
    it = start_iter
    epoch = it // per_epoch
    while it < max_iters:
        skip = it - epoch * per_epoch
        for bi, idx in enumerate(sampler.global_batch_indices(epoch,
                                                              batch_size)):
            if bi < skip:
                continue
            yield load_raw_batch(dataset, idx, buffer_hw=(buffer, buffer),
                                 max_edge=buffer)
            it += 1
            if it >= max_iters:
                return
        epoch += 1


def device_aug_batches(raw, device, generator, *, base_size: int,
                       crop_size: int):
    """The raw buffers augmented on ``device``: ``(images (B, 3, crop,
    crop), labels (B, crop, crop))`` tensors that stay there."""
    for imgs, msks, valid in raw:
        yield augment_batch(
            torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2)
            .contiguous(), torch.from_numpy(msks).to(device),
            torch.from_numpy(valid).to(device), generator,
            base_size=base_size, crop_size=crop_size)


def format_table(rows) -> str:
    """Two right-aligned columns between rules (tabulate's plain look)."""
    w0 = max(len(a) for a, _ in rows)
    w1 = max(len(b) for _, b in rows)
    rule = "-" * w0 + "  " + "-" * w1
    return "\n".join([rule] + [f"{a:<{w0}}  {b:>{w1}}" for a, b in rows]
                     + [rule])


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--max_iters", type=int, default=None,
                        help="override the EPOCHS-derived iteration count")
    parser.add_argument("--multihost", action="store_true",
                        help="a run over several machines (torchrun "
                             "--nnodes): requires torchrun's rendezvous "
                             "environment (" + ", ".join(RENDEZVOUS_ENV)
                             + ")")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="reuse this run directory (needed for --resume "
                             "to find earlier checkpoints; default is a "
                             "fresh timestamped directory)")
    parser.add_argument("--precision", type=str, default="default",
                        choices=["default", "bf16", "f32"],
                        help="default: TF32 in cuBLAS and cuDNN (the "
                             "reference's numerics class), bf16 products "
                             "under TRAIN.AMP; f32: TF32 off, TRAIN.AMP "
                             "ignored; bf16: every product of the models "
                             "takes bf16-rounded operands, float32 "
                             "accumulation (ops/precision.py)")
    parser.add_argument("--fused_attack", action="store_true",
                        help="make the adversarial examples through the "
                             "block kernels (UperNet only); the update "
                             "differentiates the plain module")
    args = parser.parse_args(argv)
    missing = [k for k in RENDEZVOUS_ENV if k not in os.environ]
    if args.multihost and missing:
        parser.error(f"--multihost: launch it with torchrun; no {missing} in "
                     "the environment")
    return args


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    t = TrainSettings.from_cfg(cfg["TRAIN"])
    precision = resolve_precision(args.precision, t.amp)
    if precision == "f32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        set_numerics()
    # JAX's global config covers the whole run: attacks, updates, evals
    with bf16_products(precision == "bf16"):
        run(args, cfg, t, precision)


def run(args, cfg, t: TrainSettings, precision: str):
    """The training run of ``main`` once its numerics are set: on one
    card, or on this rank of the world ``torchrun`` describes."""
    device = resolve_device(cfg)
    group = setup(device.type)
    try:
        train(args, cfg, t, precision, group,
              device if group is None else group.device)
    finally:
        teardown(group)


def train(args, cfg, t: TrainSettings, precision: str, group, device):
    """``run`` on ``device``, data-parallel over ``group`` (or alone)."""
    dataset_cfg, model_cfg = cfg["DATASET"], cfg["MODEL"]
    n_cls = dataset_cfg["N_CLS"]
    model_name = model_cfg["NAME"]
    backbone = model_cfg.get("BACKBONE", "")
    seed = dataset_cfg.get("SEED", 0)
    clean = "clean" in str(cfg.get("ADDENDUM", ""))
    main_rank = is_main(group)
    world = world_size(group)
    rank = 0 if group is None else group.rank
    # the JAX CLI's check (tools/train.py:117-119)
    if not (t.batch_size % world == 0 or t.batch_size >= world):
        raise SystemExit(f"global batch {t.batch_size} vs {world} ranks")
    per_rank = max(t.batch_size // world, 1)

    save_dir = str(cfg.get("SAVE_DIR", "./outputs"))
    if args.run_dir:
        save_path = args.run_dir
    else:
        stamp = str(datetime.datetime.now())[:-7].replace(" ", "-").replace(
            ":", "_")
        save_path = os.path.join(
            save_dir, str(dataset_cfg["NAME"]),
            f"{model_name}_{backbone}_adv_{t.adversarial}_{stamp}_"
            f"{t.attack}_{t.loss_fn}{cfg.get('ADDENDUM', '')}")
    save_path = broadcast_object(save_path, group)  # rank 0's time stamp
    os.makedirs(save_path, exist_ok=True)
    logger = Logger(os.path.join(save_path, "train_log") if main_rank
                    else None, quiet=not main_rank)
    logger.log(str(cfg))

    torch.manual_seed(seed)
    module = build_model(model_name, backbone, n_cls,
                         image_size=t.image_size, pspnet_clean=clean,
                         fused=False if model_name == UPERNET else None)
    pretrained = model_cfg.get("PRETRAINED")
    if pretrained and os.path.exists(str(pretrained)):
        n = load_pir(module, model_name, backbone, str(pretrained), clean)
        logger.log(f"PIR init ({model_name}): loaded {n} robust tensors "
                   f"from {pretrained}")
    module.to(device)
    replicate(module, group)

    train_ds = get_segmentation_dataset(
        dataset_cfg["NAME"], root=dataset_cfg["ROOT"], split="train",
        mode="train", base_size=t.base_size, crop_size=t.image_size,
        seed=seed)
    eval_cfg = cfg["EVAL"]
    val_ds = get_segmentation_dataset(
        dataset_cfg["NAME"], root=dataset_cfg["ROOT"], split="val",
        mode="val", base_size=eval_cfg.get("BASE_SIZE", t.base_size),
        crop_size=eval_cfg.get("IMAGE_SIZE", t.image_size))
    iters_per_epoch = len(train_ds) // t.batch_size
    max_iters = args.max_iters or t.epochs * iters_per_epoch
    logger.log(f"device={device} batch={t.batch_size} "
               f"iters/epoch={iters_per_epoch} max_iters={max_iters}")
    if group is not None:
        logger.log(f"data-parallel: {world} ranks ({group.backend}), "
                   f"{per_rank} images a rank")
    logger.log(f"precision: {precision} ({PRECISION_LOG[precision]}; "
               f"--precision {args.precision}, TRAIN.AMP {t.amp})")

    frozen = None
    if t.freeze:
        frozen = freeze_mask(module)
        logger.log("TRAIN.FREEZE: backbone parameters frozen (not in the "
                   "optimizer)")
    if not t.ddp and world > 1:
        logger.log(f"note: TRAIN.DDP=false is ignored: the port runs "
                   f"data-parallel over all {world} ranks")
    opt, sched = build_optimizer(cfg, model_name, module, max_iters,
                                 iters_per_epoch, frozen_mask=frozen)
    attack = AttackConfig(enabled=t.adversarial, name=t.attack,
                          loss_fn=t.loss_fn, eps=t.eps / 255.0,
                          n_iters=t.n_iters)
    twin = None
    if args.fused_attack:
        if model_name != UPERNET:
            raise SystemExit("--fused_attack supports UperNet only")
        # parameters come from the trained module at every call
        with torch.device("meta"):
            twin = build_model(model_name, backbone, n_cls, fused=True)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    trainer = Trainer(module, model_name, opt, attack, twin=twin,
                      generator=generator, group=group)

    ckpt_mgr = CheckpointManager(os.path.join(save_path, "ckpts"))
    if args.resume:
        # rank 0's checkpoint on every rank: the ranks need not share a disk
        state = broadcast_object(ckpt_mgr.restore() if main_rank else None,
                                 group)
        if state is not None:
            trainer.load_state_dict(state)
            logger.log(f"Resumed from step {trainer.step}")

    def save(write):
        """``write()`` on rank 0, then the ranks meet."""
        if main_rank:
            write()
        barrier(group)

    if t.device_aug:
        aug_gen = torch.Generator(device=device)
        aug_gen.manual_seed(seed + 7 if group is None
                            else fold_seed(seed + 7, rank))
        loader = device_aug_batches(
            prefetch(raw_batches(train_ds, batch_size=per_rank,
                                 max_iters=max_iters, seed=seed,
                                 start_iter=trainer.step,
                                 buffer=2 * t.base_size, num_shards=world,
                                 host_id=rank), depth=2),
            device, aug_gen, base_size=t.base_size,
            crop_size=t.image_size[0])
    else:
        loader = (
            (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
            for x, y in prefetch(IterationBasedLoader(
                train_ds, batch_size=per_rank, max_iters=max_iters,
                seed=seed, start_iter=trainer.step, num_shards=world,
                num_hosts=world, host_id=rank), depth=2))
    eval_bs = per_rank * world

    def run_eval(n_batches=None):
        if n_batches is None:
            n_batches = t.eval_batches
        hist = torch.zeros((n_cls, n_cls), dtype=torch.float32,
                           device=device)
        for x, y in simple_eval_loader(val_ds, eval_bs, n_batches):
            if x.shape[0] != eval_bs:
                # pad the tail batch; its rows are all ignore labels, so
                # they add nothing to the confusion matrix
                reps = eval_bs - x.shape[0]
                x = np.concatenate([x, np.repeat(x[-1:], reps, axis=0)])
                y = np.concatenate(
                    [y, np.full((reps,) + y.shape[1:], -1, y.dtype)])
            hist = trainer.eval_step(
                shard_batch(torch.from_numpy(x), group).to(device),
                shard_batch(torch.from_numpy(y), group).to(device), hist)
        return metrics_from_hist(hist)

    best_miou, best_aacc = 0.0, 0.0
    best_json = os.path.join(save_path, "best.json")
    b = None
    if args.resume and main_rank and os.path.exists(best_json):
        with open(best_json) as f:
            b = json.load(f)
    b = broadcast_object(b, group)
    if b is not None:
        best_miou, best_aacc = b["best_miou"], b["best_aacc"]
        logger.log(f"Restored best-so-far: mIoU={best_miou:.4f} "
                   f"aAcc={best_aacc:.4f}")
    t0 = time.time()
    start_it = trainer.step
    train_loss, window = 0.0, 0
    log_every = max(iters_per_epoch // 2, 1)
    eval_every = max(iters_per_epoch * t.eval_freq, 1)

    for it, (imgs, lbls) in enumerate(loader, start=start_it):
        loss = trainer.train_step(imgs, lbls)
        train_loss += float(loss)
        window += 1
        if (it + 1) % log_every == 0:
            done = it - start_it + 1
            eta = (time.time() - t0) / done * (max_iters - it - 1)
            logger.log(
                "Epoch: {:d}/{:d} | Iters: {:d}/{:d} || Lr: {:.6f} || "
                "Loss: {:.7f} || ETA: {}".format(
                    it // max(iters_per_epoch, 1) + 1, t.epochs, it,
                    max_iters, float(sched(it)),
                    train_loss / max(window, 1),
                    str(datetime.timedelta(seconds=int(eta)))))
            train_loss, window = 0.0, 0
        if (it + 1) % eval_every == 0:
            m = run_eval()
            logger.log(f"Epoch [{it // max(iters_per_epoch, 1) + 1}] val "
                       f"mIoU={m['mIoU']:.4f} aAcc={m['aAcc']:.4f}")
            save(lambda: ckpt_mgr.save(trainer.step, trainer.state_dict()))
            if m["mIoU"] > best_miou:
                best_miou = m["mIoU"]
                save(lambda: save_weights(
                    os.path.join(save_path, "best_model.pth"), module))
            best_aacc = max(best_aacc, m["aAcc"])

            def write_best():
                with open(best_json, "w") as f:
                    json.dump({"best_miou": best_miou,
                               "best_aacc": best_aacc}, f)
            save(write_best)

    # endgame; parity: train_rob_seg.py:426-454
    def save_last():
        if ckpt_mgr.latest_step() != trainer.step:  # not saved by an eval
            ckpt_mgr.save(trainer.step, trainer.state_dict())
    save(save_last)
    save(lambda: save_weights(os.path.join(save_path, "final_model.pth"),
                              module))
    elapsed = time.gmtime(time.time() - t0)
    logger.log(format_table([
        ("Best mIoU", f"{best_miou:.2f}"), ("Best aAcc", f"{best_aacc:.2f}"),
        ("Total Training Time", time.strftime("%H:%M:%S", elapsed))]))
    best_path = os.path.join(save_path, "best_model.pth")
    if broadcast_object(os.path.exists(best_path), group):
        if main_rank:
            module.load_state_dict(torch.load(best_path,
                                              map_location=device))
        replicate(module, group)
        logger.log("Reloaded best checkpoint for the final evaluation")
    m = run_eval(n_batches=-1)
    logger.log(format_table([("full mIoU", f"{m['mIoU']:.2f}"),
                             ("full aAcc", f"{m['aAcc']:.2f}")]))
    counts = gather_objects(kernels.launch_counts(), group)
    logger.log("kernel launches: " + json.dumps(
        {k: sum(c[k] for c in counts) for k in counts[0]}))
    if group is not None:
        logger.log("kernel launches by rank: " + json.dumps(counts))


if __name__ == "__main__":
    main()
