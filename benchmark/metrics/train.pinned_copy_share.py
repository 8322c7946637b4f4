"""Percent of the train batches copied to the card through a pinned slot (counters ``train.copies_pinned`` over ``train.copies``)."""

from benchmark.metrics._spans import counter_share


def read(run):
    return counter_share("train.copies_pinned", "train.copies")
