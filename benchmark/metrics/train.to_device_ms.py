"""Host ms the feed's thread takes to put a batch on the card (``train.to_device``)."""

from benchmark.metrics._spans import worker_host_ms


def read(run):
    return worker_host_ms(run, "train.to_device")
