"""Runs whose timed path is broken underneath come out not correct: each
fault a cell can have, planted in the program on the CPU, the rest of the
run as it is (the look for a card aside)."""

import pytest
import torch

from benchmark.tests import small


def test_training_step_that_leaves_the_state_unchanged(monkeypatch):
    from image_caption_tpu_torch.train import step
    monkeypatch.setattr(step, "apply_update",
                        lambda state, loss, mesh=None: None)
    assert not small.run("flagship.train_xe")["correct"]


def test_training_on_half_the_batch(monkeypatch):
    from image_caption_tpu_torch.train import step
    real = step.xe_loss

    def half(model, f, p, c, **kw):
        n = len(f) // 2
        return real(model, f[:n], p[:n], c[:n], **kw)
    monkeypatch.setattr(step, "xe_loss", half)
    assert not small.run("flagship.train_xe")["correct"]


def test_extraction_with_a_feature_altered(monkeypatch):
    from image_caption_tpu_torch.vision import pipeline
    real = pipeline.resnet_features

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[1] += out.abs().max()
        return out
    monkeypatch.setattr(pipeline, "resnet_features", altered)
    assert not small.run("flagship.extract")["correct"]


def test_extraction_with_the_boxes_moved(monkeypatch):
    """A detector whose boxes are off (a stride or an offset wrong).  One
    pick moved alone is not caught in bf16: the detection numbers there
    are medians over the picks (PERF.md section 6, PR 15)."""
    from image_caption_tpu_torch.vision import pipeline
    real = pipeline.yolov5_detect

    def moved(*a, **k):
        det = real(*a, **k)
        return det._replace(boxes=det.boxes + 50.0)
    monkeypatch.setattr(pipeline, "yolov5_detect", moved)
    assert not small.run("flagship.extract")["correct"]


@pytest.mark.parametrize("name", ["frcnn.caption"])
def test_captioning_with_a_token_altered(monkeypatch, name):
    from image_caption_tpu_torch import serve
    real = serve._decode

    def altered(*a, **k):
        tokens = real(*a, **k).clone()
        tokens[0, 3] = (tokens[0, 3] + 1) % 12000
        return tokens
    monkeypatch.setattr(serve, "_decode", altered)
    torch.manual_seed(0)
    assert not small.run(name, seconds=2.0)["correct"]
