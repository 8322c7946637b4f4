"""Host ms a caption batch waits on the JPEG loader (``serve.load_wait``)."""

from benchmark.metrics._spans import unit_host_ms


def read(run):
    return unit_host_ms(run, "serve.batch", "serve.load_wait")
