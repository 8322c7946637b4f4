"""Host ms of one train_step_device call: the benchmark's span around it."""

from benchmark.metrics._shares import mean_ms


def read(run):
    return mean_ms(run, "train.step")
