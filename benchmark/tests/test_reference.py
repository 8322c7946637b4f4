"""The reference against the program at small sizes on the CPU: the same
weights and inputs give the same answers."""

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.data import images as I
from benchmark.data import split as S
from benchmark.data import weights as W
from benchmark.drivers import _vision as V
from benchmark.reference import captioner as RC
from benchmark.reference import vision as RV
from benchmark.tests import small


def flagship():
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           "flagship.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("split_objects", [True, False])
def test_captioner_logits(split_objects):
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.models.captioner import Captioner
    cfg = flagship()
    m = dict(cfg["model"], split_image_objects=split_objects,
             encode_mask=split_objects)
    model_cfg = get_preset(cfg["train_preset"]).model
    from dataclasses import replace
    model = Captioner(replace(model_cfg, split_image_objects=split_objects,
                              encode_mask=split_objects), device="cpu")
    w = W.captioner(m, 7, "cpu")
    model.load_state_dict(w)
    f, p, c, _ = S.make_split(m, 8, 1, 3, "cpu")
    f, p, c = (torch.tensor(f[:4]), torch.tensor(p[:4]),
               torch.tensor(c[:4]).long())
    with torch.no_grad():
        got = model(f, p, c)
    want = RC.logits(w, m, f, p, c)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


def test_captioner_greedy_tokens_have_no_gap():
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.models.decoding import greedy_decode
    cfg = flagship()
    m = cfg["model"]
    model = Captioner(get_preset(cfg["preset"]).model, device="cpu")
    w = W.captioner(m, 11, "cpu")
    model.load_state_dict(w)
    f, p, _, _ = S.make_split(m, 8, 1, 5, "cpu")
    f, p = torch.tensor(f[:3]), torch.tensor(p[:3])
    tokens, _ = greedy_decode(model, f, p, device="cpu")
    assert float(RC.token_gaps(w, m, f, p, tokens).max()) < 1e-4


def test_training_cell_follows_the_program():
    line = small.run("flagship.train_xe")
    assert line["correct"], line["checks"]
    assert line["checks"]["train.loss_gap"]["value"] < 1e-5


def test_yolo_extraction_in_float32_is_the_programs():
    from image_caption_tpu_torch.vision.pipeline import \
        extract_features_batch
    c = small.cell("flagship.extract")
    ctx = harness.Context(c, 12345, 1, "cpu", "/tmp")
    ex = V.Extractor(ctx)
    canv, mt, sz = I.canvases(2, 99, 640, "cpu")
    tap = V.detector_tap(ex)
    try:
        f, p, _ = extract_features_batch(
            ex.params, canv.numpy(), mt, sz, num_objects=36, max_obj=5,
            compute_dtype=torch.float32, use_kernel=True, device="cpu")
    finally:
        tap.remove()
    got = V.judge(ex, canv, torch.tensor(mt), torch.tensor(sz),
                  V.program_picks(ex, tap.last), f, p)
    assert got["det.box"] == 0 and got["det.score"] == 0
    assert got["det.skipped"] == 0 and got["slot.err"] < 1e-5
    picks = RV.nms(*V.candidates(ex, canv), **RV.YOLO_NMS)
    assert torch.equal(picks.classes, tap.last.classes.long())


def test_frcnn_caption_cell_follows_the_program():
    line = small.run("frcnn.caption", seconds=2.0)
    assert line["correct"], line["checks"]
    assert line["checks"]["slot.err"]["value"] < 1e-5
    assert line["checks"]["decode.token_gap"]["value"] < 1e-4
