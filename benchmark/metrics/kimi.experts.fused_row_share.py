"""Percent of the routed rows that went through kernel #6, the routed experts' glue (counters ``moe.rows_fused`` over ``moe.rows_routed``); nothing where the program keeps no ``moe.rows_fused``."""

from benchmark.metrics._spans import counter_share, records


def read(run):
    recs = records()
    if recs is None or "moe.rows_fused" not in recs["counters"]:
        return None
    return counter_share("moe.rows_fused", "moe.rows_routed")
