"""Device ms of one greedy step over the latent cache (``decode.step``, under ``serve.decode_batch``), per step."""

from benchmark.metrics._spans import device_ms, records, under_units


def read(run):
    recs = records()
    if recs is None:
        return None
    spans, _ = under_units(recs, "serve.decode_batch",
                           run.cell.traffic["trace_units"])
    xs = [device_ms(s) for s in spans if s["name"] == "decode.step"]
    if not xs or any(x is None for x in xs):
        return None
    return sum(xs) / len(xs)
