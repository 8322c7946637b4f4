"""The port's ``demo`` path against the JAX package's on the same weights:
``extract_single_image`` (square and rectangular letterbox), then the
``demo`` verb on ``--device cpu`` (its caption, greedy and beam, and its
overlays pixel for pixel), and the two new verbs' command lines."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu import main as JMAIN
from image_caption_tpu.config import get_preset as jax_preset
from image_caption_tpu.train.checkpoint import CheckpointManager as JCkpt
from image_caption_tpu.train.state import TrainState as JState
from image_caption_tpu.train.state import make_optimizer
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu.vision import yolov5 as JY
from image_caption_tpu_torch import main as TMAIN
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
from image_caption_tpu_torch.train.state import create_train_state
from image_caption_tpu_torch.utils.io import save_pickle
from image_caption_tpu_torch.vision import pipeline as TP

from test_torch_captioner import port_model
from test_torch_etl import init_yolov5
from test_torch_resnet import torchvision_state_dict
from test_torch_yolov5 import ultralytics_state_dict

PRESET = "maxlen49_64"
OVER = {"model.num_vocab": 40, "model.num_objects": 8,
        "model.max_length": 13}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A tiny extractor written to a weights directory as the checkpoint
    files the port reads (yolov5x.npz, resnet101.npz), and the same
    weights as JAX parameters."""
    wdir = tmp_path_factory.mktemp("weights")
    template = init_yolov5(jax.random.PRNGKey(0), depth_multiple=0.33,
                           width_multiple=0.25)
    sd_y = ultralytics_state_dict(template, seed=3)
    sd_r = torchvision_state_dict((1, 1, 1, 1), seed=4)
    np.savez(wdir / "yolov5x.npz", **sd_y)
    np.savez(wdir / "resnet101.npz", **sd_r)
    jx = JP.ExtractorParams(yolo=JY.import_torch_state_dict(sd_y),
                            resnet=JR.import_torch_state_dict(
                                sd_r, (1, 1, 1, 1)))
    return str(wdir), jx


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image
    rng = np.random.RandomState(9)
    small = rng.randint(0, 256, (12, 16, 3), np.uint8)
    path = str(tmp_path_factory.mktemp("img") / "street.jpg")
    Image.fromarray(small).resize((150, 110), Image.BILINEAR).save(
        path, quality=92)
    return path


@pytest.fixture()
def jax_f32(monkeypatch):
    """The JAX package's extraction in float32 (its single-image path has
    no dtype option; bf16 rounds differently there and here)."""
    monkeypatch.setattr(JP, "extract_features_batch", functools.partial(
        JP.extract_features_batch, compute_dtype=jnp.float32))


@pytest.mark.parametrize("rect", [False, True])
def test_extract_single_image_matches_jax(rect, weights, image, jax_f32,
                                          monkeypatch):
    wdir, jx = weights
    monkeypatch.setitem(JP._EXTRACTORS, ("yolo", wdir), jx)
    want = JP.extract_single_image(image, num_objects=8, max_obj=3,
                                   weights_dir=wdir, rect=rect)
    got = TP.extract_single_image(image, num_objects=8, max_obj=3,
                                  weights_dir=wdir, rect=rect,
                                  compute_dtype=torch.float32, device="cpu")
    (gf, gp, gb), (wf, wp, wb) = got, [np.asarray(a) for a in want]
    assert gf.shape == wf.shape == (9, 2048) and gp.shape == (9, 84)
    np.testing.assert_allclose(gb, wb, atol=1e-3)
    np.testing.assert_allclose(gp, wp, atol=1e-5)
    assert np.abs(gf - wf).max() <= 1e-4 * np.abs(wf).max()
    assert (wdir, "cpu") in TP._EXTRACTORS          # loaded once


def test_extract_single_image_refuses_faster_rcnn(image):
    with pytest.raises(NotImplementedError, match="Faster R-CNN"):
        TP.extract_single_image(image, image_model="FasterRCNN",
                                device="cpu")
    with pytest.raises(ValueError, match="image_model"):
        TP.extract_single_image(image, image_model="yolo", device="cpu")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One captioner's weights as a JAX (orbax) and a port checkpoint of
    epoch 1, and the vocabulary, under separate data/output paths."""
    root = tmp_path_factory.mktemp("demo")
    cfg = get_preset(PRESET).with_overrides(**OVER)
    jparams, model = port_model(cfg, seed=5)
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    vocab.update({f"w{i}": i for i in range(4, cfg.model.num_vocab)})
    paths = {}
    for pkg in ("jax", "port"):
        data, out = root / pkg / "data", root / pkg / "out"
        save_pickle(vocab, str(data / "train" / "word_index.pkl"))
        paths[pkg] = (str(data), str(out))
    jcfg = jax_preset(PRESET).with_overrides(**OVER)
    state = JState(step=jnp.zeros((), jnp.int32), params=jparams,
                   opt_state=make_optimizer(
                       jcfg.train.learning_rate).init(jparams))
    mgr = JCkpt(os.path.join(paths["jax"][1], "model"))
    mgr.save(1, state)
    mgr.close()
    tstate = create_train_state(cfg, device="cpu")
    tstate.model.load_state_dict(model.state_dict())
    CheckpointManager(os.path.join(paths["port"][1], "model")).save(1, tstate)
    return root, paths


def _demo(main, paths, image, wdir, pre, post, workdir, monkeypatch,
          capsys):
    """Run one package's demo verb from ``workdir`` (``pre``: options
    before the verb, ``post``: after it): its caption line and the overlay
    files it wrote, images decoded to pixels."""
    from PIL import Image
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    data, out = paths
    argv = pre + ["--preset", PRESET, "--data-path", data, "--output-path",
                  out]
    for k, v in OVER.items():
        argv += ["--set", f"{k}={v}"]
    main(argv + ["demo", "--image-path", image, "--weights-dir", wdir,
                 "--save-img"] + post)
    caption = capsys.readouterr().out.splitlines()[0]
    files = {}
    out_dir = workdir / "demo" / "street" / "YOLOv5"
    for name in sorted(os.listdir(out_dir)):
        path = out_dir / name
        files[name] = (np.asarray(Image.open(path)) if name.endswith(".jpg")
                       else path.read_text())
    return caption, files


@pytest.mark.parametrize("beam", [None, 3])
def test_demo_verb_matches_jax(beam, weights, image, checkpoints, jax_f32,
                               monkeypatch, capsys):
    """The port's demo on the CPU prints the JAX demo's caption and writes
    the same overlay files (detections; attention per word when greedy),
    pixel for pixel."""
    wdir, jx = weights
    root, paths = checkpoints
    monkeypatch.setitem(JP._EXTRACTORS, ("yolo", wdir), jx)
    monkeypatch.setenv("ICX_COMPILE_CACHE", "")     # no cache under $HOME
    monkeypatch.setattr(TP, "extract_single_image", functools.partial(
        TP.extract_single_image, compute_dtype=torch.float32))
    post = ["--beam-size", str(beam)] if beam else []
    want_caption, want = _demo(JMAIN.main, paths["jax"], image, wdir, [],
                               post, root / f"jax_{beam}", monkeypatch,
                               capsys)
    got_caption, got = _demo(TMAIN.main, paths["port"], image, wdir,
                             ["--device", "cpu"], post,
                             root / f"port_{beam}", monkeypatch, capsys)
    assert got_caption == want_caption and got_caption
    assert sorted(got) == sorted(want)
    assert "det_street.jpg" in got and "labels_street.txt" in got
    assert any(n.startswith("0_") for n in got) == (beam is None)
    for name, value in want.items():
        if isinstance(value, str):         # "label x1 y1 x2 y2" per box
            rows = [line.split() for line in value.splitlines()]
            got_rows = [line.split() for line in got[name].splitlines()]
            assert [r[0] for r in got_rows] == [r[0] for r in rows]
            np.testing.assert_allclose(
                np.asarray([r[1:] for r in got_rows], float),
                np.asarray([r[1:] for r in rows], float), atol=1e-3)
        else:
            np.testing.assert_array_equal(got[name], value, name)


def test_demo_verb_needs_a_checkpoint(weights, image, tmp_path):
    wdir, _ = weights
    save_pickle({"<NULL>": 0}, str(tmp_path / "d" / "train" /
                                   "word_index.pkl"))
    with pytest.raises(SystemExit, match="no checkpoint"):
        TMAIN.main(["--device", "cpu", "--preset", PRESET,
                    "--data-path", str(tmp_path / "d"),
                    "--output-path", str(tmp_path / "o"), "demo",
                    "--image-path", image, "--weights-dir", wdir])


@pytest.mark.parametrize("argv", [
    ["demo", "--image-path", "x.jpg", "--epoch", "3", "--beam-size", "2",
     "--save-img", "--max-obj", "4", "--weights-dir", "w"],
    ["demo", "--image-path", "x.jpg"],
    ["features", "--coco-root", "r", "--splits", "train", "valid",
     "--batch-size", "16", "--weights-dir", "w"],
    ["features", "--coco-root", "r"]])
def test_new_verbs_parse_as_in_the_jax_package(argv):
    """demo and features take the JAX package's options and defaults (the
    port adds --device before the verb and features' --format)."""
    got = vars(TMAIN.build_parser().parse_args(argv))
    want = vars(JMAIN.build_parser().parse_args(argv))
    for key in ("cmd", "image_path", "epoch", "beam_size", "save_img",
                "max_obj", "weights_dir", "coco_root", "splits",
                "batch_size"):
        assert got.get(key) == want.get(key), key
    assert got["device"] is None
    assert got.get("format", "hkl") == "hkl"
