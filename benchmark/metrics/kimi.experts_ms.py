"""Device ms a batch of the routed experts (``moe.experts``, every MoE layer of the prefill and the steps)."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "serve.decode_batch", "moe.experts")
