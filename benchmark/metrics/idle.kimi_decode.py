"""Percent of the traced window with nothing running on the card (the mla_moe decode)."""

from benchmark.metrics._shares import idle


def read(run):
    return idle(run)
