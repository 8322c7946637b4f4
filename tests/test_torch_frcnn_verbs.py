"""The ``features`` and ``caption`` verbs of the port with the Faster R-CNN
preset (``maxlen49_36obj_1wordCount_frcnn_256_25b_32h``: 37 slots,
95-wide positions) on ``--device cpu``, with tiny checkpoints in
``--weights-dir``: the artifacts' shapes, a rerun that extracts nothing, a
YOLOv5-built directory extracted again, rows and captions equal to
``extract_features_frcnn`` on the loader's canvases; and the Faster R-CNN
entry points on the card unless told otherwise.  The verbs run at a
256-px canvas here (``FRCNN_CANVAS`` patched) to keep the CPU run short;
``test_torch_frcnn_pipeline.py`` holds the 800-px path against the JAX
package."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.data.vocab import decode_captions
from image_caption_tpu_torch.main import main as cli_main
from image_caption_tpu_torch.models.decoding import greedy_decode
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
from image_caption_tpu_torch.train.state import create_train_state
from image_caption_tpu_torch.utils.io import load_pickle, save_pickle
from image_caption_tpu_torch.vision import etl as etl_mod
from image_caption_tpu_torch.vision import pipeline as TP
from image_caption_tpu_torch.vision.frcnn import init_frcnn
from image_caption_tpu_torch.vision.loader import load_letterboxed_batch
from image_caption_tpu_torch.vision.resnet import init_resnet

from test_torch_etl import port_extractor, write_coco_tree
from test_torch_frcnn_pipeline import OVER, PRESET, write_frcnn_weights


def tiny_frcnn_extractor(seed=0):
    """Random port weights, both ResNets cut to one block a stage (no
    JAX)."""
    gen = torch.Generator().manual_seed(seed)
    frcnn = init_frcnn(gen)
    frcnn["backbone"] = init_resnet(gen, stages=(1, 1, 1, 1))
    return TP.FrcnnExtractorParams(frcnn=frcnn,
                                   resnet=init_resnet(gen, (1, 1, 1, 1)))


CANVAS = 256


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A COCO tree of 2 train and 2 val JPEGs and a weights directory."""
    root = tmp_path_factory.mktemp("frcnn_verbs")
    write_coco_tree(str(root / "coco"), 2, 2, seed=5, side=(60, 140))
    (root / "weights").mkdir()
    write_frcnn_weights(str(root / "weights"), seed=21)
    return root


@pytest.fixture(scope="module")
def train_rows(tree):
    """The train JPEGs (sorted) and ``extract_features_frcnn``'s features
    and positions of them on the loader's canvases, with the weights
    directory's extractor."""
    images = sorted(str(p) for p in (tree / "coco" / "image" /
                                     "train2017").iterdir())
    canvases, metas, sizes = load_letterboxed_batch(images, CANVAS)
    params = TP.load_frcnn_extractor(str(tree / "weights"), device="cpu")
    feats, poss, _ = TP.extract_features_frcnn(
        params, canvases, metas, sizes, canvas=CANVAS, device="cpu")
    return images, feats, poss


@pytest.fixture()
def canvas(monkeypatch):
    for mod in (TP, etl_mod):
        monkeypatch.setattr(mod, "FRCNN_CANVAS", CANVAS)


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        cli_main(argv)
    return out.getvalue()


def test_features_verb_with_the_frcnn_preset(tree, train_rows, canvas):
    data = str(tree / "data")
    coco, weights = str(tree / "coco"), str(tree / "weights")
    # the train split built by YOLOv5 first: the same rows, another model
    cfg_yolo = get_preset(PRESET).with_overrides(**{
        "data.image_model": "YOLOv5", "model.dim_positions": 84,
        "data.data_path": data})
    etl_mod.run_etl(cfg_yolo, coco_root=coco, splits=["train"],
                    batch_size=2, extractor_params=port_extractor(3),
                    feature_format="npy", device="cpu")
    argv = ["--device", "cpu", "--preset", PRESET, "--data-path", data,
            "features", "--coco-root", coco, "--batch-size", "2",
            "--weights-dir", weights, "--format", "npy"]
    out = _run(argv)
    assert "[etl] train: stale features on disk (extraction config/" \
           "weights changed) — re-extracting" in out
    assert "random" not in out
    for split, n in (("train", 2), ("valid", 1), ("test", 1)):
        shapes = [np.load(os.path.join(data, split, f"{split}.{k}.npy"))
                  .shape for k in ("features", "positions")]
        assert shapes == [(n, 37, 2048), (n, 37, 95)], split
        with open(os.path.join(data, split,
                               f"{split}.features.meta.json")) as f:
            assert json.load(f)["fingerprint"]["image_model"] == "FasterRCNN"
    assert _run(argv).count("fingerprint matches — skipping") == 3

    # the train rows: extract_features_frcnn on the loader's canvases
    images, feats, poss = train_rows
    paths = list(load_pickle(os.path.join(data, "train",
                                          "train.file.names.pkl")))
    order = [images.index(p) for p in paths]
    feats, poss = feats[order], poss[order]
    np.testing.assert_array_equal(
        np.load(os.path.join(data, "train", "train.features.npy")),
        feats.numpy())
    got_p = np.load(os.path.join(data, "train", "train.positions.npy"))
    np.testing.assert_array_equal(got_p, poss.numpy())
    assert (got_p[:, 1:, 4:].max(axis=-1) > 0).any(axis=1).all()


def test_caption_verb_with_the_frcnn_preset(tree, train_rows, canvas):
    """``caption`` JPEGs with a tiny FRCNN-preset captioner: one JSON line
    per image, the greedy captions of ``extract_features_frcnn``'s rows."""
    cfg = get_preset(PRESET).with_overrides(**OVER)
    data, out = tree / "cap_data", tree / "cap_out"
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    vocab.update({f"w{i}": i for i in range(4, cfg.model.num_vocab)})
    save_pickle(vocab, str(data / "train" / "word_index.pkl"))
    state = create_train_state(cfg, device="cpu", seed=4)
    CheckpointManager(str(out / "model")).save(1, state)
    images, feats, poss = train_rows
    argv = ["--device", "cpu", "--preset", PRESET, "--data-path", str(data),
            "--output-path", str(out)]
    for k, v in OVER.items():
        argv += ["--set", f"{k}={v}"]
    lines = _run(argv + ["caption", "--images", *images, "--batch-size", "2",
                         "--weights-dir", str(tree / "weights")]).splitlines()
    got = [json.loads(line) for line in lines if line.startswith("{")]
    tokens, _ = greedy_decode(state.model, feats, poss, device="cpu")
    want = decode_captions(tokens.numpy(), {i: w for w, i in vocab.items()})
    assert [g["image"] for g in got] == images
    assert [g["caption"] for g in got] == want and all(want)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "init_frcnn_extractor", "load_frcnn_extractor", "extract_features_frcnn",
    "extract_single_image", "stream_extracted_batches"])
def test_frcnn_entry_points_need_cuda_unless_told_cpu(entry, tree, no_cuda,
                                                      canvas, monkeypatch):
    """Each raises without a card unless the caller says ``device="cpu"``."""
    monkeypatch.setattr(TP, "_EXTRACTORS", {})
    params = tiny_frcnn_extractor()
    image = str(next((tree / "coco" / "image" / "val2017").iterdir()))
    canvases = np.full((1, CANVAS, CANVAS, 3), 114, np.uint8)
    metas = np.array([[1.0, 0.0, 0.0]], np.float32)
    sizes = np.array([[CANVAS, CANVAS]], np.float32)
    calls = {
        "init_frcnn_extractor": lambda **kw: TP.init_frcnn_extractor(**kw),
        "load_frcnn_extractor": lambda **kw: TP.load_frcnn_extractor(
            str(tree / "weights"), **kw),
        "extract_features_frcnn": lambda **kw: TP.extract_features_frcnn(
            params, canvases, metas, sizes, num_objects=4, canvas=CANVAS,
            crop_size=32, **kw),
        "extract_single_image": lambda **kw: TP.extract_single_image(
            image, image_model="FasterRCNN", num_objects=4, **kw),
        "stream_extracted_batches": lambda **kw: list(
            etl_mod.stream_extracted_batches(
                [image], extractor_params=params, num_objects=4,
                batch_size=1, image_model="FasterRCNN", **kw)),
    }
    for dev in ("cpu", "cuda"):     # the extractor it would load: the tiny one
        TP._EXTRACTORS[(None, dev, "FasterRCNN")] = params
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    got = calls[entry](device="cpu")
    if entry == "extract_single_image":
        assert got[0].shape == (5, 2048) and got[1].shape == (5, 95)
    elif entry == "stream_extracted_batches":
        (start, real, failed, feats, poss), = got
        assert (start, real, failed) == (0, 1, [])
        assert tuple(poss.shape) == (1, 5, 95)
