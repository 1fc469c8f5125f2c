"""Background-thread batch prefetching; a copy of
``robseg_tpu/data/prefetch.py``. A bounded producer thread keeps ``depth``
batches ahead, so PIL augmentation overlaps the card's work (the reference
uses DataLoader worker processes, ``train_rob_seg.py:257``)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional


class PrefetchIterator:
    """Wrap an iterable; produce items from a daemon thread, ``depth``
    ahead; an exception in the producer is raised on the consumer's
    side."""

    _END = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            yield item


def prefetch(iterable: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth)
