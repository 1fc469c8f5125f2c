"""Data parallelism, one process a card (``mesh.py``), and a launcher of
worlds from Python (``launch.py``)."""

from robseg_torch.parallel.mesh import (  # noqa: F401
    BACKEND_ENV, RENDEZVOUS_ENV, DataGroup, all_mean_, all_sum_, barrier,
    broadcast_object, fold_seed, gather_objects, gather_rows,
    host_local_shard_count, is_main, replicate, setup, shard_batch,
    teardown, world_size)
from robseg_torch.parallel.launch import spawn_world  # noqa: F401
