"""Host input prefetching: a background thread assembles the next batches
while the loop runs the current step.

The reference's only host parallelism is torch DataLoader workers
(``features.py:94-97``).  Here one thread keeps a small queue of ready
batches ahead of the loop; what overlaps with the step is the batch
assembly on the host.  Its ``transform`` (the trainer's ``to_device``)
also issues the host-to-device copies, but from pageable memory on the
default stream, so those do not overlap the step on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_END = object()


class Prefetcher:
    """Wrap a batch iterable; map each batch with ``transform`` on the
    producer thread.  An error in the producer is raised in the consumer."""

    def __init__(self, iterable: Iterable, *, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._iterable = iterable
        self._depth = depth
        self._transform = transform

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err = []

        def produce():
            try:
                for item in self._iterable:
                    if self._transform is not None:
                        item = self._transform(item)
                    q.put(item)
            except BaseException as e:     # surface on the consumer side
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                t.join()
                if err:
                    raise err[0]
                return
            yield item
