"""YAML experiment configs with the reference's section schema.

Port of ``robseg_tpu/config.py`` (``load_config``, ``dataset_eval_geometry``,
``model_display_name``, ``TrainSettings``) plus ``resolve_device``, which
reads the YAML ``DEVICE`` key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import yaml


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def dataset_eval_geometry(name: str):
    """(base_size, crop_size) for eval; parity ``tools/infer.py:158-192``."""
    if name.lower() in ("pascalvoc", "pascalaug"):
        return 512, (473, 473)
    if name.lower() == "ade20k":
        return 520, (512, 512)
    raise ValueError(f"Unknown dataset {name!r}")


def model_display_name(model_name: str, backbone: str) -> str:
    """Parity: ``getModelName`` (``semseg/utils/utils.py:248-255``)."""
    if model_name == "SegMenter":
        return "SegMent_" + backbone
    if model_name == "UperNetForSemanticSegmentation":
        return "UperNet_" + backbone
    return "PSPNet_RN50"


def resolve_device(cfg: Dict[str, Any]) -> torch.device:
    """The config's ``DEVICE``: ``tpu``, ``gpu`` and ``cuda`` all mean the
    CUDA card, ``cpu`` means the CPU. Asking for a card on a machine
    without one raises; there is no fallback to the CPU."""
    name = str(cfg.get("DEVICE", "cuda")).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("tpu", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"DEVICE: {name} asks for a CUDA device, and none is "
                "available (set DEVICE: cpu to run on the CPU)")
        return torch.device("cuda")
    raise ValueError(f"Unknown DEVICE {name!r}")


@dataclasses.dataclass
class TrainSettings:
    """Typed view over the TRAIN section with the reference's defaults; a
    copy of ``robseg_tpu/config.py:42-94`` (same keys, same defaults).

    ``ddp`` is informational: under ``torchrun`` the port always runs
    data-parallel over the ranks, as JAX runs over the mesh (the CLI logs
    a note when it is false with more than one rank). ``eval_interval``
    is dead in the reference too. ``device_aug: true`` augments on the card
    (``data/device_transforms.py``).
    """
    base_size: int = 512
    image_size: tuple = (473, 473)
    batch_size: int = 16
    epochs: int = 50
    adversarial: bool = True
    attack: str = "pgd"
    loss_fn: str = "pgd"
    eps: float = 4.0
    n_iters: int = 5
    amp: bool = False
    ddp: bool = True
    eval_interval: int = 32
    freeze: bool = False
    device_aug: bool = False
    # periodic eval: every EVAL_FREQ epochs on EVAL_BATCHES val batches
    # (-1 = the full split)
    eval_freq: int = 20
    eval_batches: int = 20

    @classmethod
    def from_cfg(cls, t: Dict[str, Any]) -> "TrainSettings":
        return cls(
            base_size=t.get("BASE_SIZE", 512),
            image_size=tuple(t.get("IMAGE_SIZE", (473, 473))),
            batch_size=t.get("BATCH_SIZE", 16),
            epochs=t.get("EPOCHS", 50),
            adversarial=t.get("ADVERSARIAL", True),
            attack=t.get("ATTACK", "pgd"),
            loss_fn=t.get("LOSS_FN", "pgd"),
            eps=float(t.get("EPS", 4)),
            n_iters=t.get("N_ITERS", 5),
            amp=t.get("AMP", False),
            ddp=t.get("DDP", True),
            eval_interval=t.get("EVAL_INTERVAL", 32),
            freeze=t.get("FREEZE", False),
            device_aug=t.get("DEVICE_AUG", False),
            eval_freq=t.get("EVAL_FREQ", 20),
            eval_batches=t.get("EVAL_BATCHES", 20),
        )
