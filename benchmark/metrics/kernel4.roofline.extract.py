"""Kernel #4's share of its roofline over its launches in the traced window (extract)."""

from benchmark.metrics._shares import kernel4_roofline


def read(run):
    return kernel4_roofline(run)
