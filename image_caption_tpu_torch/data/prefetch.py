"""Host input prefetching: a background thread assembles the next batches
while the loop runs the current step, and on the card copies them off the
compute stream.

The reference's only host parallelism is torch DataLoader workers
(``features.py:94-97``).  Here one thread keeps a small queue of ready
batches ahead of the loop.  Its ``transform`` (the trainer's
``to_device``, or ``shard_stacked`` for a chunk of ``train.scan_steps``
batches) also puts each batch on the device.  On a CUDA device that is a
``PinnedCopier``: the host arrays are copied into page-locked slots, and
the host-to-device copies run on the trainer's own stream, so they
overlap the step already queued on the compute stream.  The compute
stream waits for them on the device when the batch is handed to the loop
(``on_handoff``); no thread waits for the step.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Deque, Dict, Iterable, Iterator, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from ..utils.debug import annotate, count, restart_device

_END = object()

# pinned slots a (shape, dtype): a slot is free again once its copy has
# run, a few ms after it is enqueued, so the feed seldom waits for one
SLOTS = 4

_producing = threading.local()     # .hooks: the hand-over work of the item


def on_handoff(fn: Callable[[], None]) -> bool:
    """Run ``fn`` on the consumer's thread when the item that a
    ``Prefetcher``'s transform is making is handed over, before the
    consumer sees it.  Outside such a transform it returns False and runs
    nothing: the caller is the consumer."""
    hooks = getattr(_producing, "hooks", None)
    if hooks is None:
        return False
    hooks.append(fn)
    return True


class Prefetcher:
    """Wrap a batch iterable; map each batch with ``transform`` on the
    producer thread, and run the work the transform left for the hand-over
    (``on_handoff``) on the consumer's thread as each item is taken.  An
    error in the producer is raised in the consumer."""

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
                items = iter(self._iterable)
                while True:
                    with annotate("prefetch.assemble"):
                        item = next(items, _END)
                    if item is _END:
                        break
                    hooks = _producing.hooks = []
                    try:
                        if self._transform is not None:
                            item = self._transform(item)
                    finally:
                        _producing.hooks = None
                    q.put((item, hooks))
            except BaseException as e:     # surface on the consumer side
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            got = q.get()
            if got is _END:
                t.join()
                if err:
                    raise err[0]
                return
            item, hooks = got
            for hook in hooks:
                hook()
            yield item


class _Slot:
    """A page-locked buffer and the event after the copy that last read
    it."""

    __slots__ = ("buffer", "copied")

    def __init__(self):
        self.buffer: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None


class PinnedCopier:
    """Host batches to one CUDA device, off its compute stream.

    ``copy`` copies each host leaf (torch's multi-threaded ``copy_``) into
    a page-locked slot, one of a ring of ``SLOTS`` a (shape, dtype) made at
    first use, enqueues the host-to-device copies on the copier's own
    ``stream``, casts there where the dtype asks, and records one event
    after the batch's last copy.  The compute stream waits on that event
    on the device: at the hand-over to the consumer where ``copy`` runs as
    a ``Prefetcher``'s transform, else at once on the caller's current
    stream.  Each device tensor is then marked as used there
    (``record_stream``), so that the caching allocator hands its memory to
    the copy stream again only once the step has read it.  A slot is
    refilled once the copy that last read it has run: the filling thread
    waits for it (counter ``train.slot_waits``), never the compute stream.
    Calls from several threads take turns."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._rings: Dict[Tuple, Deque[_Slot]] = {}
        self._lock = threading.Lock()

    def copy(self, leaves: Sequence, dtypes: Sequence[torch.dtype]
             ) -> Tuple[torch.Tensor, ...]:
        """Numpy arrays or CPU tensors -> tensors of ``dtypes`` on the
        device, bitwise what ``.to(device, dtype)`` gives."""
        with self._lock:
            slots = [self._stage(x) for x in leaves]
            with torch.cuda.stream(self.stream):
                restart_device()     # the span's device time is the copy
                out = tuple(s.buffer.to(self.device, non_blocking=True)
                            .to(dtype) for s, dtype in zip(slots, dtypes))
                done = self.stream.record_event()
            for s in slots:
                s.copied = done
        count("train.copies_pinned", 1)

        def ready():
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for x in out:
                x.record_stream(compute)

        if not on_handoff(ready):
            ready()
        return out

    def _stage(self, x) -> _Slot:
        """The next slot of ``x``'s ring, holding a copy of ``x``."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        key = (tuple(x.shape), x.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(_Slot() for _ in range(SLOTS))
        slot = ring[0]
        ring.rotate(-1)
        if slot.buffer is None:
            slot.buffer = torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=True)
        elif not slot.copied.query():
            count("train.slot_waits", 1)
            slot.copied.synchronize()
        slot.buffer.copy_(x)
        return slot
