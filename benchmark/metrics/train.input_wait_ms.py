"""Host ms the loop waits on the Prefetcher for its next device batch."""

from benchmark.metrics._shares import mean_ms


def read(run):
    return mean_ms(run, "train.input_wait")
