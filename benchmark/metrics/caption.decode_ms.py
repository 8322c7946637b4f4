"""Device ms a caption batch of the greedy decode (``decode.greedy``)."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "serve.batch", "decode.greedy")
