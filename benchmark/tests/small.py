"""Cells of BENCHMARK.json cut to what a CPU test run holds: the same
drivers, configurations and code paths, small batches, and for the
extraction cells small detectors and one block a ResNet stage."""

import torch

from benchmark import harness


def cell(name: str) -> harness.Cell:
    c = harness.resolve(name)
    ex = dict(c.config["extractor"])
    if ex["detector"] == "YOLOv5":
        ex.update(depth_multiple=0.33, width_multiple=0.25,
                  resnet_stages=[1, 1, 1, 1])
    else:
        ex.update(trunk_stages=[1, 1, 1, 1], resnet_stages=[1, 1, 1, 1])
    c.config = dict(c.config, extractor=ex)
    small = {"train_xe": dict(batch=4, images=8, captions_per_image=2),
             "extract": dict(batch=2, warm_batches=1, check_batches=1),
             "caption": dict(batch=2, max_images=40, warm_batches=1,
                             check_batches=1)}[
        c.traffic["driver"]]
    c.traffic = dict(c.traffic, **small)
    return c


def run(name: str, seconds: float = 1.0, seed: int = 2 ** 31 + 99,
        control=None):
    torch.manual_seed(0)
    return harness.execute(cell(name), seed, seconds, False, device="cpu",
                           control=control)
