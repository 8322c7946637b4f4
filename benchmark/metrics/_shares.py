"""What the per-layer readers share: shares of the traced window, of the
card's peaks and of kernel #4's bound, and host spans."""

from __future__ import annotations

from typing import Optional

from benchmark.flops import least_seconds
from benchmark.flops.vision import IDENTITY_RUNS, identity_run_bound

KERNEL4 = r"stack_kernel"


def idle(run) -> Optional[float]:
    """Percent of the traced window in which nothing ran on the card."""
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> Optional[float]:
    """Percent: the least time of the traced units' work at the card's
    peaks over the traced window."""
    flops = {k: v * run.cell.traffic["trace_units"]
             for k, v in run.window.flops_per_unit.items()}
    if not flops:
        return None
    return 100.0 * least_seconds(flops) / run.trace.window_s


def kernel4_roofline(run) -> Optional[float]:
    """Percent: kernel #4's bound over its device time, launch by launch
    (four a batch: ResNet-101's identity runs of stages 1-4)."""
    if run.window.kernel4 is None:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNEL4)
    if launches == 0:
        return None
    crops, dtype = run.window.kernel4
    bound = sum(identity_run_bound(IDENTITY_RUNS[i % 4], crops, dtype)
                for i in range(launches))
    return 100.0 * bound / seconds


def mean_ms(run, span: str) -> Optional[float]:
    xs = run.window.spans.get(span)
    return 1e3 * sum(xs) / len(xs) if xs else None
