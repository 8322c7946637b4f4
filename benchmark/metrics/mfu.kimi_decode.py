"""Percent of the card's bf16 peak that the traced greedy batches' operations (``flops/kimi_vl.py``) would take of the traced window."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run)
