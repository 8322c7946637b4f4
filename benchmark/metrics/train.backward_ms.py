"""Device ms a step of ``train.backward``, less what the batch copies (``train.to_device``) cover."""

from benchmark.metrics._spans import unit_device_ms


def read(run):
    return unit_device_ms(run, "train.step", "train.backward",
                          minus="train.to_device")
