"""The routed experts' share of their roofline (percent): the least time of the traced batches' grouped expert calls over the device time of their ``moe.experts`` spans.

A call's bound (``flops/kimi_vl.experts_bound_seconds``) is the larger of
its touched experts' three matrices read once plus its routed rows in and
out at 3.35 TB/s, and its routed rows' products at 989 TFLOP/s.  A batch
makes one call a MoE layer in the prefill (``batch`` x (slots + 1) x k
rows) and one in each of ``max_length - 2`` steps (``batch`` x k rows);
the experts a call touches are the counter ``moe.experts_touched`` over
the calls it counted (the counters ran from the profiler's start, the
warm batch included: their calls are ``moe.rows_routed`` over a batch's
routed rows).  The bound counts the work, whatever implements the layer.
"""

from benchmark.flops import kimi_vl as FK
from benchmark.metrics._spans import records, unit_device_ms


def read(run):
    recs = records()
    if recs is None:
        return None
    seconds = unit_device_ms(run, "serve.decode_batch", "moe.experts")
    counters = recs["counters"]
    rows = counters.get("moe.rows_routed")
    touched = counters.get("moe.experts_touched")
    if seconds is None or not rows or touched is None:
        return None
    c, b = run.cell.config, run.cell.traffic["batch"]
    k = c["num_experts_per_tok"]
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    steps = c["captioner"]["max_length"] - 2
    prefill_rows = b * FK.prefill_tokens(c) * k
    batch_rows = layers * (prefill_rows + steps * b * k)
    calls = rows / batch_rows * layers * (1 + steps)
    each = touched / calls
    bound = layers * (FK.experts_bound_seconds(c, prefill_rows, each)
                      + steps * FK.experts_bound_seconds(c, b * k, each))
    return 100.0 * bound / (seconds * 1e-3)
