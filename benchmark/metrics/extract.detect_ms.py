"""Device ms an extraction batch of ``extract.detect``."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "extract.batch", "extract.detect")
