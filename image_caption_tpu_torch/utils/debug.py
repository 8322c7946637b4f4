"""Observability: profiling, spans and counters, NaN guards, step timing.

The counterpart of the JAX package's ``utils/debug.py``:

  * ``trace(log_dir)``: ``torch.profiler`` over a few train steps of the
    enclosed region (the host and, on the card, its kernels), written as a
    Chrome trace under ``log_dir`` (open it in chrome://tracing or
    Perfetto); ``trace_step()`` marks a step's end;
  * ``annotate(name, device=False)``: a span.  While no profiler records
    it costs one flag read.  While one does (``trace``, or any
    ``torch.profiler.profile`` of the process), it keeps the span in
    memory (host clock, thread, parent; with ``device`` a CUDA event at
    each end on the current stream) and, on the main thread, enters it in
    the trace as a ``user_annotation``; ``count(name, value)`` adds to a
    counter; ``records()`` reads both back, ``clear()`` empties them.
    The spans the port opens, outer to inner:

      - training: ``train_step`` and ``epoch_eval`` (``train()``),
        ``train.step`` (``Trainer.train_step_device``,
        ``train_steps_device``), ``train.forward``, ``train.backward`` and
        ``train.adam`` on the device (``train/step``); on the feed's
        thread, kept but not in the trace, ``prefetch.assemble``
        (``data/prefetch``) and ``train.to_device`` (host and, on the
        card, the copy on the trainer's copy stream); the counters
        ``train.copies``, ``train.copies_pinned`` and ``train.slot_waits``
        (``data/prefetch.PinnedCopier``);
      - serving: ``serve.batch`` (``serve.caption_images``, a batch from
        the request for its features to its captions), ``serve.load_wait``
        (``vision/etl``), ``decode.greedy`` (device) with one
        ``decode.step`` a step (``models/decoding``), and in a step
        ``decode.self_attention``, ``decode.cross_attention``,
        ``decode.feed_forward`` a block and ``decode.classifier``;
        ``serve.tokens_to_host``; ``serve.decode_batch`` a batch of
        ``serve.decode_split``; the ``mla_moe`` captioner's
        ``decode.greedy`` holds ``decode.prefill`` and one ``decode.step``
        a step, both on the device, and in each ``mla.attention`` a layer
        and ``moe.route``, ``moe.experts`` and ``moe.shared`` a MoE layer,
        all on the device (``models/lm``); the counters
        ``moe.rows_routed`` (rows sent to experts) and
        ``moe.experts_touched`` (the distinct experts of each MoE call,
        summed; kept on the card) from ``ops/experts``;
      - extraction: ``extract.batch`` (host and device) over
        ``extract.detect``, ``extract.crops`` and ``extract.resnet`` on the
        device (``vision/pipeline``, both detectors), ``nms.step`` a pick
        of ``vision/nms.nms_fixed``; the counters ``extract.crops`` and
        ``extract.crops_valid`` (Faster R-CNN);

    The decode's sub-layer spans and ``nms.step`` serve the trace: where
    the card waits on those loops' small launches, its idle gaps are named
    after the span open at their middle;

  * ``enable_nan_debugging()``: autograd's anomaly mode, and
    ``check_finite`` in the train steps raises on a non-finite loss or
    gradient, as ``jax_debug_nans`` raises (slow: every step waits for the
    card; never for production runs);
  * ``StepTimer``: steps per second from the end of the first, set-up
    bearing step to the end of the last.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Union

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

from ..parallel import distributed


# the steps ``trace`` records: the first (kernel builds, first use) warms
# the profiler up, the next ``TRACE_STEPS`` are kept.  A bounded window
# keeps a run of any length within host memory: the profiler holds every
# event of the window until it writes the trace.
TRACE_WARMUP_STEPS = 1
TRACE_STEPS = 5

_active: Optional[torch.profiler.profile] = None


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile ``TRACE_STEPS`` train steps of the enclosed region, after
    ``TRACE_WARMUP_STEPS``, and write them to
    ``{log_dir}/trace_rank{r}.json`` (``r`` the process's rank, 0 alone)
    when they end; ``trace_step()`` marks each step's end.  A region that
    ends sooner is written at its end, with all that ran after the
    warm-up (the epoch evaluation of a short run)."""
    global _active
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_rank{distributed.rank()}.json")
    schedule = torch.profiler.schedule(
        wait=0, warmup=TRACE_WARMUP_STEPS, active=TRACE_STEPS, repeat=1)
    with torch.profiler.profile(
            activities=activities, schedule=schedule,
            on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        _active = prof
        try:
            yield prof
        finally:
            _active = None


def trace_step() -> None:
    """The end of a train step, for the ``trace`` in progress (if any)."""
    if _active is not None:
        _active.step()


# spans kept at most between two ``clear()``: later ones are dropped, and
# counted
SPAN_LIMIT = 200_000

_NOT_RECORDING = contextlib.nullcontext()
_MAIN_THREAD = threading.main_thread().ident
_lock = threading.Lock()
_open = threading.local()          # .stack: the thread's open spans
_spans: List["_Span"] = []
_dropped = 0
_counters: Dict[str, Union[int, torch.Tensor]] = {}
_first_event: Optional[torch.cuda.Event] = None


class _Span:
    """One span of ``annotate`` while a profiler records."""

    __slots__ = ("name", "device", "stream", "thread", "parent", "index",
                 "t0", "t1", "events", "mark")

    def __init__(self, name: str, device: bool,
                 stream: Optional[torch.cuda.Stream]):
        self.name, self.device, self.stream = name, device, stream

    def __enter__(self) -> "_Span":
        global _dropped, _first_event
        self.thread = threading.get_ident()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.mark = None
        if self.thread == _MAIN_THREAD:
            self.mark = record_function(self.name)
            self.mark.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t1 = None
        self.t0 = time.perf_counter_ns()
        with _lock:
            self.parent = (outer.index if outer is not None
                           and outer.index is not None
                           and outer.index < len(_spans)
                           and _spans[outer.index] is outer else None)
            if len(_spans) < SPAN_LIMIT:
                self.index = len(_spans)
                _spans.append(self)
                if self.events is not None and _first_event is None:
                    _first_event = self.events[0]
            else:
                self.index = None
                _dropped += 1
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.mark is not None:
            self.mark.__exit__(*exc)
        _open.stack.pop()


def annotate(name: str, device: bool = False,
             stream: Optional[torch.cuda.Stream] = None):
    """A span named ``name`` (context manager).  While no profiler records
    (``_is_profiler_enabled``: it follows the profiler's schedule, and
    every thread sees it) it reads that flag and does nothing more.
    While one records it keeps the span (host clock, thread, the innermost
    span open on the same thread as its parent) and, on the main thread
    only, enters ``record_function(name)``, so the trace carries it;
    ``device`` also records a CUDA event at each end on ``stream`` (the
    current stream when None), without a wait.  Spans of other threads
    stay out of the trace: its idle gaps are named by the host event
    running at their middle, whatever its thread."""
    if not _profiler._is_profiler_enabled:
        return _NOT_RECORDING
    return _Span(name, device, stream)


def recording() -> bool:
    """Whether a profiler records: guards a counter whose value costs a
    launch to compute."""
    return _profiler._is_profiler_enabled


def restart_device() -> None:
    """Record the device start of the innermost span open on this thread
    again, here: for a span whose own host work (staging a copy) comes
    before its device work.  Nothing while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_open, "stack", None)
    if stack and stack[-1].events is not None:
        stack[-1].events[0].record(stack[-1].stream)


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` to counter ``name`` while a profiler records; a
    tensor adds its sum, kept on its device (nothing is read)."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        value = value.sum()
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def records() -> Dict:
    """The spans and counters kept since the last ``clear()``; call it
    after the device work of the spans has been waited for.

    ``spans``: one dict each, in the order they were opened: ``name``,
    ``thread``, ``main`` (the main thread's), ``parent`` (the index of the
    enclosing span, or None), ``host_ms`` (None while open) and, for a
    device span, ``device_start_ms`` and ``device_end_ms`` on one device
    clock (from the first event kept), so that spans of different threads
    can be set against each other; ``counters``: name -> total;
    ``dropped``: spans past ``SPAN_LIMIT``."""
    with _lock:
        spans, counters, dropped = list(_spans), dict(_counters), _dropped
        ref = _first_event
    if ref is not None:
        torch.cuda.synchronize()
    out = []
    for s in spans:
        rec = {"name": s.name, "thread": s.thread,
               "main": s.thread == _MAIN_THREAD, "parent": s.parent,
               "host_ms": None if s.t1 is None else (s.t1 - s.t0) / 1e6,
               "device_start_ms": None, "device_end_ms": None}
        if s.events is not None and s.t1 is not None:
            rec["device_start_ms"] = ref.elapsed_time(s.events[0])
            rec["device_end_ms"] = ref.elapsed_time(s.events[1])
        out.append(rec)
    totals = {k: (v.item() if isinstance(v, torch.Tensor) else v)
              for k, v in counters.items()}
    return {"spans": out, "counters": totals, "dropped": dropped}


def clear() -> None:
    """Empty the kept spans and counters."""
    global _dropped, _first_event
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
        _first_event = None


def enable_nan_debugging(enable: bool = True) -> None:
    """Debug mode: autograd's anomaly mode, under which ``check_finite``
    raises on a non-finite loss or gradient."""
    torch.autograd.set_detect_anomaly(enable)


def check_finite(name: str, tensors: Iterable[torch.Tensor],
                 step: int) -> None:
    """Raise ``FloatingPointError`` if any of ``tensors`` holds a NaN or
    an infinity, in debug mode only (it waits for the device); outside it
    ``tensors`` is not read."""
    if not torch.is_anomaly_enabled():
        return
    tensors = list(tensors)
    if not tensors:
        return
    if not bool(torch.stack([torch.isfinite(t).all() for t in tensors])
                .all()):
        raise FloatingPointError(f"non-finite {name} at step {step} "
                                 "(--debug-nans)")


class StepTimer:
    """Steps/sec over the steps after the first (set-up bearing) call: from
    the end of the first call to the end of the last, whenever it is
    read."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._steps = 0

    def step(self, n: int = 1) -> None:
        """Record n steps completed by one call (n > 1: a K-step call).  The
        first call is excluded entirely: the clock starts when it ends."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        else:
            self._steps += n
            self._t_last = now

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._steps == 0:
            return None
        return self._steps / (self._t_last - self._t0)
