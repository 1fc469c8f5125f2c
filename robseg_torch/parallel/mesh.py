"""Data parallelism over processes, one a card: the counterpart of
``robseg_tpu/parallel/mesh.py``.

The JAX package runs one program over a 1-D ``data`` mesh of every visible
device. The port runs what the reference runs on GPUs: one process a card,
joined by ``torch.distributed`` (NCCL on CUDA, gloo on the CPU), its ranks
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``). A :class:`DataGroup` stands where the
JAX functions take a ``mesh``; ``None`` is the one-process path, on which
every function here does nothing.

  * ``shard_batch``: a rank's contiguous slice of a global batch, rank 0's
    first (``P("data")``);
  * ``replicate``: rank 0's parameters and buffers broadcast to all ranks
    (``P()``);
  * ``all_sum_`` / ``all_mean_``: ``psum`` / ``pmean`` in place, through
    one flat buffer a dtype (one collective for all gradients);
  * ``gather_rows``: host arrays concatenated over the ranks in rank
    order, through an object gather (small host-side results);
  * ``host_local_shard_count``: the ranks this host feeds.

Tensor collectives are ``all_reduce`` and ``broadcast`` only: gloo takes
CUDA tensors for those two, so a world of ranks sharing one card runs
under gloo (``ROBSEG_DIST_BACKEND=gloo``). NCCL is what a CUDA run uses
otherwise; a failed NCCL start raises, and no rank falls back to gloo or
to the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# picks the backend of a CUDA world: "nccl" (the default) or "gloo", the
# one that lets ranks share a card
BACKEND_ENV = "ROBSEG_DIST_BACKEND"
# torchrun's rendezvous variables (``--multihost`` requires them)
RENDEZVOUS_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The default process group as this rank sees it. ``owned``: made by
    :func:`setup`, so :func:`teardown` destroys it."""
    rank: int
    size: int
    local_size: int
    device: torch.device
    backend: str
    owned: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def is_main(group: Optional[DataGroup]) -> bool:
    """Rank 0, or the one process without a group: the one that logs and
    writes files."""
    return group is None or group.is_main


def world_size(group: Optional[DataGroup]) -> int:
    return 1 if group is None else group.size


def setup(device_type: str, *, init_method: str = "env://",
          timeout_s: Optional[float] = None) -> Optional[DataGroup]:
    """Join the world that ``torchrun``'s environment describes, on
    ``device_type`` (``"cuda"`` or ``"cpu"``). Without that environment,
    and with no group started already, returns ``None``: the one-process
    path. A group started already (by a launcher) is reused and left to
    its starter.

    CUDA: rank r runs on ``cuda:{LOCAL_RANK}``, set before the group
    starts; the backend is NCCL, or gloo when ``ROBSEG_DIST_BACKEND=gloo``
    asks for it, in which case local ranks beyond the card count share the
    cards in turn. The CPU: gloo."""
    if dist.is_initialized():
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_type == "cuda" else torch.device("cpu"))
        size = dist.get_world_size()
        return DataGroup(dist.get_rank(), size,
                         int(os.environ.get("LOCAL_WORLD_SIZE", size)),
                         device, dist.get_backend(), owned=False)
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if device_type == "cuda":
        backend = os.environ.get(BACKEND_ENV, "nccl")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"{BACKEND_ENV}={backend!r}: nccl or gloo")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({n_cards} "
                f"visible); NCCL needs one card a rank ({BACKEND_ENV}=gloo "
                "lets ranks share cards)")
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        backend = "gloo"
        device = torch.device("cpu")
    else:
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kw["device_id"] = device  # start the communicator now: a failure
        # raises here, not at the first collective
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, **kw)
    return DataGroup(rank, size, local_size, device, backend, owned=True)


def teardown(group: Optional[DataGroup]) -> None:
    if group is not None and group.owned and dist.is_initialized():
        dist.destroy_process_group()


def barrier(group: Optional[DataGroup]) -> None:
    if group is not None:
        if group.backend == "nccl":
            dist.barrier(device_ids=[group.device.index])
        else:
            dist.barrier()


def shard_batch(x: torch.Tensor, group: Optional[DataGroup]
                ) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading axis (``:32-47``),
    rank 0's first; the axis must divide by the world size."""
    if group is None:
        return x
    n = x.shape[0]
    if n % group.size:
        raise ValueError(f"batch {n} does not divide over {group.size} "
                         "ranks")
    per = n // group.size
    return x[group.rank * per:(group.rank + 1) * per]


def _coalesced(tensors: List[torch.Tensor], op) -> None:
    """``op(flat)`` on one flat buffer a dtype, copied back in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_sum_(tensors: Iterable[torch.Tensor],
             group: Optional[DataGroup]) -> None:
    """``psum`` in place: each tensor becomes its sum over the ranks."""
    if group is not None:
        _coalesced(list(tensors), dist.all_reduce)


def all_mean_(tensors: Iterable[torch.Tensor],
              group: Optional[DataGroup]) -> None:
    """``pmean`` in place: the sum over the ranks, divided by their
    count."""
    if group is not None:
        def op(flat):
            dist.all_reduce(flat)
            flat.div_(group.size)
        _coalesced(list(tensors), op)


def replicate(module: torch.nn.Module, group: Optional[DataGroup]) -> None:
    """Rank 0's parameters and buffers on every rank (``:50-52``)."""
    if group is not None:
        with torch.no_grad():
            _coalesced([t.data for t in module.parameters()]
                       + list(module.buffers()),
                       lambda flat: dist.broadcast(flat, 0))


def gather_rows(arrays, group: Optional[DataGroup]):
    """Each rank's host array (or tuple of arrays) concatenated along the
    leading axis in rank order, through one object gather: each rank's
    rows of a batch back into the whole batch."""
    if group is None:
        return arrays
    parts = gather_objects(arrays, group)
    if isinstance(arrays, tuple):
        return tuple(np.concatenate(p) for p in zip(*parts))
    return np.concatenate(parts)


def gather_objects(obj: Any, group: Optional[DataGroup]) -> list:
    """Every rank's ``obj``, in rank order."""
    if group is None:
        return [obj]
    parts: List[Any] = [None] * group.size
    dist.all_gather_object(parts, obj)
    return parts


def broadcast_object(obj: Any, group: Optional[DataGroup]) -> Any:
    """Rank 0's ``obj`` on every rank (a decision or a path all ranks must
    share)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def host_local_shard_count(group: Optional[DataGroup]) -> int:
    """Shards this host feeds: its ranks (``:55-57``)."""
    return 1 if group is None else group.local_size


def fold_seed(seed: int, *values: int) -> int:
    """A seed derived from ``seed`` and ``values`` (JAX's ``fold_in``):
    a generator per (seed, step, rank)."""
    return int(np.random.SeedSequence([seed, *values]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
