"""The latent-attention kernel's share of its roofline (percent): its bound
over the device time of its launches in the traced batches' decode steps.

The kernel (``csrc/mla_decode.cu``, found by name) runs once a layer in
each of a batch's ``max_length - 2`` steps; at step s it attends the cache
rows 0..pos with pos = ``prefill_tokens`` + s, of which the pad slots of
the prefix are hidden.  Its bound is the bytes it has to move at 3.35 TB/s
(``batch`` x its visible rows of kv_lora_rank + qk_rope bf16 in, q of the
same width and the latent output of kv_lora_rank out, a head each) or its
products over those rows at 989 TFLOP/s, whichever is longer, launch by
launch.  A batch row's visible rows at pos are the prefix's visible keys
and the tokens after it; the program's counters give the prefix's share of
visible keys (``mla.prefix_keys_visible`` over ``mla.prefix_keys``, since
the profiler started, the warm batch included), so the bound is the mean
batch row's.  The pad rows the kernel loads count as no work.  Only the
launches of the traced units count: the program's spans give each traced
``serve.decode_batch`` its ``decode.step`` count, and the trace's last
launches, in time order (the window closes after the last traced unit),
are theirs, so each maps to its step and pos even where the window did
not open on a batch boundary.  None where the program has no such kernel
or kept no spans or counters.
"""

from benchmark.flops import ELEM_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS
from benchmark.flops import kimi_vl as FK
from benchmark.metrics._spans import records, under_units

KERNEL = r"mla_decode_kernel"


def launch_bound_seconds(c, batch: int, rows: float) -> float:
    """The least time of one launch whose batch rows attend ``rows`` cache
    rows each (a mean)."""
    h, r, e = (c["num_attention_heads"], c["kv_lora_rank"],
               c["qk_rope_head_dim"])
    bytes_ = ELEM_BYTES["bf16"] * batch * (rows * (r + e) + h * (2 * r + e))
    flops = 2 * batch * h * rows * (2 * r + e)
    return max(bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["bf16"])


def visible_rows(c, pos: int, prefix_visible: float) -> float:
    """A batch row's visible cache rows at ``pos``: the prefix's share
    ``prefix_visible`` of its keys and every token after it."""
    start = FK.prefill_tokens(c)
    return prefix_visible * start + (pos - start + 1)


def read(run):
    recs = records()
    if recs is None:
        return None
    launches = sorted(d for n, ds in run.trace.kernels.items()
                      if KERNEL in n for d in ds)
    keys = recs["counters"].get("mla.prefix_keys")
    seen = recs["counters"].get("mla.prefix_keys_visible")
    if not launches or not keys or seen is None:
        return None
    spans, _ = under_units(recs, "serve.decode_batch",
                           run.cell.traffic["trace_units"])
    steps = []
    for s in spans:
        if s["name"] == "serve.decode_batch" and s["parent"] is None:
            steps.append(0)
        elif s["name"] == "decode.step" and steps:
            steps[-1] += 1
    c = run.cell.config
    layers, start = c["num_hidden_layers"], FK.prefill_tokens(c)
    poss = [start + s for n in steps for s in range(n) for _ in range(layers)]
    kept = launches[-len(poss):] if poss else []
    if not kept:
        return None
    poss = poss[-len(kept):]
    batch = run.cell.traffic["batch"]
    bound = sum(launch_bound_seconds(c, batch,
                                     visible_rows(c, p, seen / keys))
                for p in poss)
    return 100.0 * bound / sum(d for _, d in kept)
