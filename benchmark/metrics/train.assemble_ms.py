"""Host ms the feed's thread takes to assemble a batch (``prefetch.assemble``)."""

from benchmark.metrics._spans import worker_host_ms


def read(run):
    return worker_host_ms(run, "prefetch.assemble")
