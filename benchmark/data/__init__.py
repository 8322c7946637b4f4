"""Seeded inputs of the benchmark: weights, images and caption splits.

Frozen copies of the generators and weight calibrations that
``chip_smoke.py`` uses, drawn here on the card where that is faster, so
that a later edit of ``chip_smoke.py`` does not move the yardstick.
"""
