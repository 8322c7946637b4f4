"""Percent of the crops Faster R-CNN encodes that hold a detection (counters ``extract.crops_valid`` over ``extract.crops``)."""

from benchmark.metrics._spans import counter_share


def read(run):
    return counter_share("extract.crops_valid", "extract.crops")
