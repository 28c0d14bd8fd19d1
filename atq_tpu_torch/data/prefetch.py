"""Background batch prefetching for the host input pipeline.

Port of atq_tpu/data/prefetch.py: one daemon thread iterates the source a
few batches ahead through a bounded queue, so host batch assembly overlaps
the device step; an exception in the producer is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

__all__ = ["PrefetchLoader"]

_END = object()


class PrefetchLoader:
    """Iterate ``source`` on a background thread, ``depth`` batches ahead.

    Each ``__iter__`` starts a fresh thread over ``iter(source)``, so a
    re-iterable loader can be wrapped once and iterated every epoch."""

    def __init__(self, source: Iterable[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.depth = depth

    def __iter__(self) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)

        def produce():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as exc:  # re-raised in the consumer
                q.put((_END, exc))
            else:
                q.put((_END, None))

        thread = threading.Thread(target=produce, daemon=True,
                                  name="atq-torch-prefetch")
        thread.start()
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _END:
                thread.join()
                if item[1] is not None:
                    raise item[1]
                return
            yield item

    def __len__(self) -> int:
        return len(self.source)  # type: ignore[arg-type]
