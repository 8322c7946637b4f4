"""What the readers of the program's own spans and counters share.

The program keeps its spans while a profiler records
(``image_caption_tpu_torch.utils.debug``: ``annotate``, ``count``,
``records``).  A reader takes the traced units: the last ``trace_units``
(the cell's traffic file) top-level spans of the unit's name on the main
thread, and the spans under them; a span of a worker thread is taken
wherever it was recorded.  It returns the mean per unit, or None where the
program keeps no such span (a checkout without them) or, for a device
time, where the spans have none (a run on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def records() -> Optional[Dict]:
    """The program's spans and counters, or None where it keeps none."""
    from image_caption_tpu_torch.utils import debug
    read = getattr(debug, "records", None)
    return read() if read is not None else None


def under_units(recs: Dict, unit: str, n: int) -> Tuple[List[Dict], int]:
    """The spans under (and including) the last ``n`` completed top-level
    spans named ``unit``, and how many such units there are."""
    spans = recs["spans"]
    top = []
    for i, s in enumerate(spans):        # a parent precedes its children
        top.append(i if s["parent"] is None else top[s["parent"]])
    roots = [i for i, s in enumerate(spans)
             if s["name"] == unit and s["parent"] is None and s["main"]
             and s["host_ms"] is not None][-n:]
    keep = set(roots)
    return [s for i, s in enumerate(spans) if top[i] in keep], len(roots)


def device_ms(s: Dict) -> Optional[float]:
    if s["device_start_ms"] is None:
        return None
    return s["device_end_ms"] - s["device_start_ms"]


def covered(a: float, b: float, intervals: List[Tuple[float, float]]
            ) -> float:
    """How much of [a, b] the union of ``intervals`` covers."""
    total, edge = 0.0, a
    for lo, hi in sorted(intervals):
        lo, hi = max(lo, edge), min(hi, b)
        if hi > lo:
            total += hi - lo
            edge = hi
    return total


def unit_host_ms(run, unit: str, name: str,
                 per: str = "unit") -> Optional[float]:
    """Host ms of the spans ``name`` under the traced units, per unit, or
    per span with ``per="span"``."""
    recs = records()
    if recs is None:
        return None
    spans, n = under_units(recs, unit, run.cell.traffic["trace_units"])
    xs = [s["host_ms"] for s in spans
          if s["name"] == name and s["host_ms"] is not None]
    if not xs:
        return None
    return sum(xs) / (len(xs) if per == "span" else n)


def unit_device_ms(run, unit: str, name: str,
                   minus: Optional[str] = None) -> Optional[float]:
    """Device ms of the spans ``name`` under the traced units, per unit;
    ``minus``: less the part of each that the device intervals of the
    spans of that name, on any thread, cover."""
    recs = records()
    if recs is None:
        return None
    spans, n = under_units(recs, unit, run.cell.traffic["trace_units"])
    mine = [s for s in spans if s["name"] == name]
    if not mine or any(device_ms(s) is None for s in mine):
        return None
    others = [(s["device_start_ms"], s["device_end_ms"])
              for s in recs["spans"]
              if minus is not None and s["name"] == minus
              and device_ms(s) is not None]
    total = sum(device_ms(s) - covered(s["device_start_ms"],
                                       s["device_end_ms"], others)
                for s in mine)
    return total / n


def worker_host_ms(run, name: str) -> Optional[float]:
    """Mean host ms of every span ``name`` recorded off the main thread."""
    recs = records()
    if recs is None:
        return None
    xs = [s["host_ms"] for s in recs["spans"]
          if s["name"] == name and not s["main"] and s["host_ms"] is not None]
    return sum(xs) / len(xs) if xs else None


def counter_share(numerator: str, denominator: str) -> Optional[float]:
    """Percent: one counter over another."""
    recs = records()
    if recs is None:
        return None
    c = recs["counters"]
    if not c.get(denominator):
        return None
    return 100.0 * c.get(numerator, 0) / c[denominator]
