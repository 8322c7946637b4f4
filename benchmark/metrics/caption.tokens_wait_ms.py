"""Host ms a caption batch waits for its tokens (``serve.tokens_to_host``)."""

from benchmark.metrics._spans import unit_host_ms


def read(run):
    return unit_host_ms(run, "serve.batch", "serve.tokens_to_host")
