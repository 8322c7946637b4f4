"""Host ms a caption batch spends in the extraction call (``extract.batch``)."""

from benchmark.metrics._spans import unit_host_ms


def read(run):
    return unit_host_ms(run, "serve.batch", "extract.batch")
