"""Device ms a caption batch of ``extract.detect`` (Faster R-CNN's extraction)."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "serve.batch", "extract.detect")
