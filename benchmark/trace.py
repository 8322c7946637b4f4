"""The device trace of a run's traced units: busy time, idle gaps and the
kernels' times, read from ``torch.profiler``'s Chrome trace.

The traced units run inside one ``record_function`` span (``WINDOW``); its
host interval is the traced window.  Device activity (kernels, copies,
fills) is clipped to it; the busy time is the union of those intervals.
Each idle gap is named by the innermost host operation or runtime call
running at its middle (``python__between_ops`` where none is).
"""

from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "benchmark.traced_window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Total seconds and launches of kernels whose name matches."""
        rx = re.compile(pattern)
        spans = [d for n, ds in self.kernels.items() if rx.search(n)
                 for _, d in ds]
        return sum(spans), len(spans)


def short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:\-]", "_", name)[:64]


def read(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no traced window")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, host = [], []
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in _DEVICE:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                device.append((a, b, e["name"]))
        elif e.get("cat") in _HOST and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
    device.sort()
    kernels: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    busy, gaps, edge = 0.0, [], lo
    for a, b, name in device:
        kernels[name].append((a * 1e-6, (b - a) * 1e-6))
        by_name[short(name)] += (b - a) * 1e-6
        if a > edge:
            gaps.append((edge, a))
        busy += max(0.0, b - max(a, edge))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        # the host events that began last before the middle hold the
        # innermost one running there
        at = bisect.bisect_right(starts, mid)
        inner = [h for h in host[max(0, at - 256):at] if h[1] >= mid]
        label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                 else "python__between_ops")
        idle[short(label)] += (b - a) * 1e-6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
                 kernels=dict(kernels), device_ops=top(by_name),
                 idle_gaps=top(idle))


class Tracer:
    """The profiler around a run's first ``units`` units of work: started
    before the window (so that its own start-up stays out), the traced
    window opened at the window's start and closed, after a synchronise,
    once ``units`` units are enqueued."""

    def __init__(self, units: int, directory: str):
        import torch
        self.units, self.done = units, 0
        self.path = os.path.join(directory, "trace.json")
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.mark = torch.profiler.record_function(WINDOW)
        self.prof.start()

    def open(self) -> None:
        self.mark.__enter__()

    def unit_done(self) -> None:
        """Count one unit enqueued; close the traced window at ``units``."""
        import torch
        self.done += 1
        if self.done == self.units:
            torch.cuda.synchronize()
            self.mark.__exit__(None, None, None)
            self.prof.stop()

    def close(self) -> Trace:
        if self.done < self.units:
            raise RuntimeError(f"the window closed after {self.done} units, "
                               f"before the {self.units} traced")
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return read(self.path)
        finally:
            os.remove(self.path)
