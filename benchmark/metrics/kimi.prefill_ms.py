"""Device ms a batch of the prefill over the slots and <START> (``decode.prefill``, under ``serve.decode_batch``)."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "serve.decode_batch", "decode.prefill")
