"""Start a world of ranks from Python: ``torchrun`` for a function.

``spawn_world(fn, size, args)`` runs ``fn(group, *args)`` on ``size`` new
processes (the ``spawn`` start method), each joined to the others through
``parallel.setup`` with a ``file://`` rendezvous in a fresh temporary
directory (no port to pick). Each rank returns a picklable result; the
caller gets them in rank order. The world has one deadline for the group
start, the work and the join: if it passes, or a rank raises or dies, every
rank is killed and the call raises, so a failing rank cannot leave the
others waiting in a collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

from robseg_torch.parallel.mesh import BACKEND_ENV, setup, teardown


def _rank_main(fn, rank: int, size: int, init_method: str, device_type: str,
               backend: Optional[str], timeout_s: float, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    if backend is not None:
        os.environ[BACKEND_ENV] = backend
    group = None
    try:
        group = setup(device_type, init_method=init_method,
                      timeout_s=timeout_s)
        results.put((rank, True, fn(group, *args)))
    except BaseException:  # reported to the parent, which ends the world
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        teardown(group)


def spawn_world(fn: Callable, size: int, args: Sequence[Any] = (), *,
                device_type: str = "cpu", backend: Optional[str] = None,
                timeout_s: float = 120.0) -> list:
    """``[fn(group, *args) on rank r for r in range(size)]``, each rank a
    new process. ``fn`` must be importable by name (a module-level
    function). ``device_type`` ``"cuda"`` puts rank r on card r (NCCL);
    ``backend="gloo"`` lets ranks share cards. Raises ``RuntimeError``
    with the rank's traceback if a rank raises or dies, and
    ``TimeoutError`` after ``timeout_s`` seconds; every rank is ended
    either way."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="robseg_world_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, size, init_method, device_type,
                               backend, timeout_s, tuple(args), results))
             for r in range(size)]
    deadline = time.monotonic() + timeout_s
    got = {}
    ended = False
    try:
        for p in procs:
            p.start()
        while len(got) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {size} ranks not done in {timeout_s:.0f} s; "
                    f"ranks done: {sorted(got)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            got[rank] = value
        ended = True
    finally:
        for p in procs:
            if ended:  # the ranks are tearing their group down
                p.join(timeout=max(min(deadline - time.monotonic(), 30.0),
                                   0.1))
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(size)]
