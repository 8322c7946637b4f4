"""Device ms a batch of latent attention (``mla.attention``, every layer of the prefill and the steps)."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "serve.decode_batch", "mla.attention")
