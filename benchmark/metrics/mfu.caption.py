"""Percent of the card's peaks that the traced caption work's operations would take of the traced window."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run)
