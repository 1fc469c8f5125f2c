"""Checkpoints: the full resume state and reference-layout weights.

Counterpart of ``robseg_tpu/train/checkpoint.py`` (orbax there):
  * ``CheckpointManager`` writes the whole training state with
    ``torch.save`` (step, model, optimizer, the generator's state), keeps
    the newest ``max_to_keep``, and restores the newest; a resumed run is
    bit-for-bit the straight run;
  * ``save_weights`` writes a module's ``state_dict``: for UperNet, PSPNet
    and the Segmenter the reference layout, which ``robseg_torch.infer``
    and ``robseg_tpu/convert/torch2jax.py`` both read. The JAX
    trainer's ``.npz`` files are read by ``convert/from_jax.py``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        return sorted(int(m[1]) for m in map(_CKPT.match,
                                             os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` for ``step`` (through a temporary file, so a
        killed save leaves the earlier checkpoints intact)."""
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=False)


def save_weights(path: str, module: torch.nn.Module) -> None:
    """The module's ``state_dict`` on the CPU (the ``.pth`` of the
    reference trainer, ``train_rob_seg.py:405-419``)."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)
