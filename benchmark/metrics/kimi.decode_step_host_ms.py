"""Host ms of one greedy step's enqueue over the latent cache (``decode.step``), per step."""

from benchmark.metrics._spans import unit_host_ms


def read(run):
    return unit_host_ms(run, "serve.decode_batch", "decode.step", per="span")
