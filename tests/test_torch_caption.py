"""Serving from image files: the port's ``caption_images`` against the JAX
package's on JPEGs, a tiny extractor and a tiny captioner with the same
weights; batch-size invariance, ``skip_errors``, streaming callbacks; and
the ``caption`` verb end to end on the CPU after a one-epoch port ``train``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu import serve as JS
from image_caption_tpu.config import get_preset
from image_caption_tpu.data.vocab import invert_vocab
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu.vision import yolov5 as JY
from image_caption_tpu_torch import serve as TS
from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.main import main as cli_main
from image_caption_tpu_torch.utils.weights import (
    resnet_state_from_jax_params, yolov5_state_from_jax_params)
from image_caption_tpu_torch.vision.pipeline import ExtractorParams

from test_torch_captioner import port_model
from test_torch_resnet import torchvision_state_dict
from test_torch_yolov5 import ultralytics_state_dict


@pytest.fixture(scope="module")
def cfg():
    return get_preset("maxlen49_64").with_overrides(**{
        "model.num_vocab": 40, "model.num_objects": 4,
        "model.max_length": 13})


def _write_jpegs(directory, n, seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        img = (rng.rand(40 + 8 * i, 56 + 4 * i, 3) * 255).astype(np.uint8)
        p = os.path.join(directory, f"im{i}.jpg")
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def setup(cfg, tmp_path_factory):
    """JPEGs, a tiny extractor and a tiny captioner in both packages, and
    the vocabulary."""
    paths = _write_jpegs(str(tmp_path_factory.mktemp("imgs")), 5)
    jx = JP.ExtractorParams(
        yolo=JY.init_yolov5(jax.random.PRNGKey(0), depth_multiple=0.33,
                            width_multiple=0.25),
        resnet=JR.init_resnet(jax.random.PRNGKey(1), stages=(1, 1, 1, 1)))
    tx = ExtractorParams(yolo=yolov5_state_from_jax_params(jx.yolo),
                         resnet=resnet_state_from_jax_params(jx.resnet))
    jc, tc = port_model(cfg, seed=2)
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    vocab.update({f"w{i}": i for i in range(4, cfg.model.num_vocab)})
    return paths, jx, tx, jc, tc, invert_vocab(vocab)


@pytest.fixture(scope="module")
def jax_captions(cfg, setup):
    """The JAX package's captions, greedy and beam 2, with its extraction
    in float32 (its ``caption_images`` has no dtype option; bf16 there and
    here round differently and may pick other boxes)."""
    paths, jx, _, jc, _, idx_to_word = setup
    f32 = functools.partial(JP.extract_features_batch,
                            compute_dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "extract_features_batch", f32)
        return {beam: JS.caption_images(cfg, paths, jc, idx_to_word,
                                        extractor_params=jx, beam_size=beam,
                                        batch_size=2, num_workers=2)
                for beam in (None, 2)}


@pytest.mark.parametrize("beam", [None, 2])
def test_caption_images_match_jax(beam, cfg, setup, jax_captions):
    paths, _, tx, _, tc, idx_to_word = setup
    got = TS.caption_images(cfg, paths, tc, idx_to_word, extractor_params=tx,
                            beam_size=beam, batch_size=2, num_workers=2,
                            compute_dtype=torch.float32, device="cpu")
    assert got == jax_captions[beam]
    assert len(got) == 5 and all(isinstance(c, str) for c in got)


def test_caption_images_batch_size_invariant(cfg, setup):
    paths, _, tx, _, tc, idx_to_word = setup
    kw = dict(extractor_params=tx, num_workers=2, device="cpu")
    ragged = TS.caption_images(cfg, paths, tc, idx_to_word, batch_size=2,
                               **kw)
    full = TS.caption_images(cfg, paths, tc, idx_to_word, batch_size=5, **kw)
    assert ragged == full


def test_caption_images_beam_progress_and_stream(cfg, setup):
    paths, _, tx, _, tc, idx_to_word = setup
    seen, streamed = [], []
    caps = TS.caption_images(
        cfg, paths, tc, idx_to_word, extractor_params=tx, beam_size=2,
        batch_size=3, num_workers=2, device="cpu",
        progress=lambda done, n: seen.append((done, n)),
        on_batch=lambda start, c: streamed.append((start, c)))
    assert seen == [(3, 5), (5, 5)]
    assert streamed == [(0, caps[:3]), (3, caps[3:])]


def test_caption_images_skip_errors(cfg, setup, tmp_path):
    paths, _, tx, _, tc, idx_to_word = setup
    bad = str(tmp_path / "corrupt.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg at all")
    mixed = [paths[0], bad, paths[1]]
    kw = dict(extractor_params=tx, num_workers=2, device="cpu")
    with pytest.raises(Exception):
        TS.caption_images(cfg, mixed, tc, idx_to_word, batch_size=3, **kw)
    caps = TS.caption_images(cfg, mixed, tc, idx_to_word, batch_size=3,
                             skip_errors=True, **kw)
    clean = TS.caption_images(cfg, [paths[0], paths[1]], tc, idx_to_word,
                              batch_size=2, **kw)
    assert caps[1] is None and [caps[0], caps[2]] == clean
    lines = [json.loads(x) for x in TS.caption_images_to_jsonl(mixed, caps)]
    assert lines[1] == {"image": bad, "error": "unreadable image"}
    assert lines[0] == {"image": paths[0], "caption": caps[0]}
    assert list(TS.caption_images_to_jsonl(mixed, caps)) == \
        list(JS.caption_images_to_jsonl(mixed, caps))


def test_list_images_matches_jax(tmp_path):
    for name in ("b.jpg", "a.PNG", "c.txt", "d.jpeg", "e.webp"):
        (tmp_path / name).write_bytes(b"x")
    (tmp_path / "thumbnails.jpg").mkdir()
    got = TS.list_images(str(tmp_path))
    assert [os.path.basename(p) for p in got] == ["a.PNG", "b.jpg", "d.jpeg",
                                                  "e.webp"]
    assert got == JS.list_images(str(tmp_path))


def test_caption_verb_end_to_end(setup, tmp_path):
    """``train`` one epoch on synthetic data, then ``caption`` JPEGs from
    its checkpoint with a tiny extractor from ``--weights-dir``, all with
    ``--device cpu``: one JSON line per image, error records with
    ``--skip-errors``."""
    paths, jx, *_ = setup
    data, out = tmp_path / "data", tmp_path / "out"
    vocab = generate_synthetic_dataset(
        str(data), num_images={"train": 8, "valid": 4, "test": 2},
        num_slots=7, max_length=9, seed=1)
    common = ["--device", "cpu", "--preset", "maxlen49_64",
              "--set", f"model.num_vocab={len(vocab)}",
              "--set", "model.max_length=11", "--set", "model.num_objects=6",
              "--set", "train.batch_size=16", "--data-path", str(data),
              "--output-path", str(out)]
    cli_main(common + ["train", "--epochs", "1"])
    weights = tmp_path / "weights"
    weights.mkdir()
    np.savez(weights / "yolov5x.npz", **ultralytics_state_dict(jx.yolo))
    np.savez(weights / "resnet101.npz",
             **torchvision_state_dict((1, 1, 1, 1)))
    bad = str(tmp_path / "corrupt.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8 truncated")
    jsonl = tmp_path / "caps.jsonl"
    cli_main(common + ["caption", "--images", *paths, bad, "--weights-dir",
                       str(weights), "--batch-size", "2", "--beam-size", "2",
                       "--skip-errors", "--out", str(jsonl)])
    lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert [x["image"] for x in lines] == paths + [bad]
    assert all(isinstance(x["caption"], str) for x in lines[:5])
    assert lines[5]["error"] == "unreadable image"
    # the same weights as a reference model_N.pt (a bare state_dict)
    state = torch.load(out / "model" / "train_state_1.pt", weights_only=True)
    torch.save(state["model"], tmp_path / "model_1.pt")
    ref_jsonl = tmp_path / "ref.jsonl"
    cli_main(common + ["caption", "--images", *paths, "--weights-dir",
                       str(weights), "--batch-size", "2", "--beam-size", "2",
                       "--checkpoint", str(tmp_path / "model_1.pt"),
                       "--out", str(ref_jsonl)])
    assert ref_jsonl.read_text().splitlines() == \
        jsonl.read_text().splitlines()[:5]
    with pytest.raises(SystemExit):
        cli_main(common + ["caption", "--images", *paths, "--epoch", "9"])
