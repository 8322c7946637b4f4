"""Observability: profiling, NaN guards, step timing.

The counterpart of the JAX package's ``utils/debug.py``:

  * ``trace(log_dir)``: ``torch.profiler`` over a few train steps of the
    enclosed region (the host and, on the card, its kernels), written as a
    Chrome trace under ``log_dir`` (open it in chrome://tracing or
    Perfetto); ``trace_step()`` marks a step's end;
  * ``annotate(name)``: a named range inside a trace;
  * ``enable_nan_debugging()``: autograd's anomaly mode, and
    ``check_finite`` in the train steps raises on a non-finite loss or
    gradient, as ``jax_debug_nans`` raises (slow: every step waits for the
    card; never for production runs);
  * ``StepTimer``: steps per second with the first, set-up bearing step
    left out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterable, Iterator, Optional

import torch

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


def annotate(name: str):
    """A named range inside an active trace (context manager)."""
    return torch.profiler.record_function(name)


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
    """Steps/sec with the first (set-up bearing) step excluded."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._steps = 0
        self._first_step_s: Optional[float] = None
        self._t_start = time.perf_counter()

    def step(self, n: int = 1) -> None:
        """Record n steps completed by one call (n > 1: a K-step call).  The
        first call is excluded entirely: the clock starts when it ends."""
        now = time.perf_counter()
        if self._first_step_s is None:
            self._first_step_s = now - self._t_start
            self._t0 = now
        else:
            self._steps += n

    @property
    def compile_seconds(self) -> Optional[float]:
        """The first call's seconds from ``reset``: the kernels' build and
        first-use set-up, with the step."""
        return self._first_step_s

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._t0 is None or self._steps == 0:
            return None
        return self._steps / (time.perf_counter() - self._t0)
