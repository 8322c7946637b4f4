"""The port's Faster R-CNN extraction against the JAX package's on the same
weights: ``extract_features_frcnn`` on 256-px canvases (both ResNet routes),
``extract_single_image(image_model="FasterRCNN")`` at the path's 800-px
canvas, and the ``demo`` verb with the FRCNN preset on ``--device cpu``
(its greedy caption and its overlays pixel for pixel; beam search does
not depend on the detector, and ``test_torch_demo.py`` holds it).  The
port reads its tiny checkpoints from a weights directory; the JAX package
gets the same weights from the same state_dicts."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu import main as JMAIN
from image_caption_tpu.config import get_preset as jax_preset
from image_caption_tpu.train.checkpoint import CheckpointManager as JCkpt
from image_caption_tpu.train.state import TrainState as JState
from image_caption_tpu.train.state import make_optimizer
from image_caption_tpu.vision import ops as JO
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu_torch import main as TMAIN
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
from image_caption_tpu_torch.train.state import create_train_state
from image_caption_tpu_torch.utils.io import save_pickle
from image_caption_tpu_torch.utils.weights import (
    frcnn_state_from_jax_params, resnet_state_from_jax_params)
from image_caption_tpu_torch.vision import pipeline as TP

from test_torch_captioner import port_model
from test_torch_frcnn import (calibrate_heads, frcnn_torchvision_state_dict,
                              jax_import)
from test_torch_resnet import torchvision_state_dict
from test_torch_yolov5 import assert_same_tree

PRESET = "maxlen49_36obj_1wordCount_frcnn_256_25b_32h"
# the FRCNN preset's captioner cut to a few narrow layers; its 37 slots
# and 95-wide positions stay
OVER = {"model.num_vocab": 40, "model.max_length": 13,
        "model.encode_input_size": 32, "model.encode_q_k_dim": 32,
        "model.encode_v_dim": 32, "model.encode_hidden_size": 32,
        "model.encode_num_heads": 4, "model.encode_num_blocks": 1,
        "model.dim_word_embedding": 32, "model.decode_input_size": 32,
        "model.decode_q_k_dim": 32, "model.decode_v_dim": 32,
        "model.decode_hidden_size": 32, "model.decode_num_heads": 4,
        "model.decode_num_blocks": 2}


def write_frcnn_weights(directory, seed=0):
    """``fasterrcnn_resnet50_fpn.npz`` (a ResNet-50 body of one block a
    stage, calibrated heads) and ``resnet101.npz`` (one block a stage)
    written to ``directory``; returns the JAX package's
    ``FrcnnExtractorParams`` of the same weights."""
    sd_f = calibrate_heads(frcnn_torchvision_state_dict(seed=seed))
    sd_r = torchvision_state_dict((1, 1, 1, 1), seed=seed + 50)
    np.savez(os.path.join(directory, "fasterrcnn_resnet50_fpn.npz"), **sd_f)
    np.savez(os.path.join(directory, "resnet101.npz"), **sd_r)
    return JP.FrcnnExtractorParams(
        frcnn=jax_import(sd_f),
        resnet=JR.import_torch_state_dict(sd_r, (1, 1, 1, 1)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The weights directory, the JAX package's extractor and the port's
    as ``load_frcnn_extractor`` reads it."""
    wdir = str(tmp_path_factory.mktemp("weights"))
    jx = write_frcnn_weights(wdir, seed=11)
    return wdir, jx, TP.load_frcnn_extractor(wdir, device="cpu")


def test_load_frcnn_extractor_reads_the_weights_dir(weights, tmp_path,
                                                    capsys):
    wdir, jx, tx = weights
    assert_same_tree(tx.frcnn, frcnn_state_from_jax_params(jx.frcnn))
    assert_same_tree(tx.resnet, resnet_state_from_jax_params(jx.resnet))
    assert tx.device.type == "cpu"
    assert "random" not in capsys.readouterr().out
    monkey = pytest.MonkeyPatch()
    try:                     # without files: random weights, said so
        monkey.setattr(TP, "init_frcnn_extractor",
                       lambda device=None: "random")
        assert TP.load_frcnn_extractor(str(tmp_path), device="cpu") == \
            "random"
    finally:
        monkey.undo()
    assert "frcnn weights not found" in capsys.readouterr().out


def _canvases(seed, size=256):
    """Two images letterboxed by the JAX package, metas and sizes."""
    rng = np.random.RandomState(seed)
    canv, metas, sizes = [], [], ((180, 256), (256, 120))
    for h, w in sizes:
        c, m = JO.letterbox_image(
            jnp.asarray(rng.rand(h, w, 3).astype(np.float32) * 255), size)
        canv.append(np.asarray(c))
        metas.append(np.asarray(m))
    return np.stack(canv), np.stack(metas), np.asarray(sizes, np.float32)


def _compare(got, want):
    """Features within 1e-4 x max|ref|, positions 1e-5, boxes 1e-3 px."""
    gf, gp, gb = (np.asarray(t) for t in got)
    wf, wp, wb = (np.asarray(t) for t in want)
    assert gf.shape == wf.shape and gp.shape == wp.shape
    np.testing.assert_allclose(gb, wb, atol=1e-3)
    np.testing.assert_allclose(gp, wp, atol=1e-5)
    assert np.abs(gf - wf).max() <= 1e-4 * np.abs(wf).max()


@pytest.fixture(scope="module")
def batch_run(weights):
    _, jx, _ = weights
    canv, metas, sizes = _canvases(0)
    want = JP.extract_features_frcnn(jx, jnp.asarray(canv),
                                     jnp.asarray(metas), jnp.asarray(sizes),
                                     num_objects=6, canvas=256, crop_size=64)
    return (canv, metas, sizes), [np.asarray(t) for t in want]


@pytest.mark.parametrize("as_tensors", [False, True])
def test_extract_features_frcnn_matches_jax(as_tensors, weights, batch_run):
    """numpy inputs, or CPU tensors (as a caller holding them passes)."""
    _, _, tx = weights
    inputs, want = batch_run
    args = ([torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
            if as_tensors else inputs)
    got = TP.extract_features_frcnn(tx, *args, num_objects=6, canvas=256,
                                    crop_size=64, device="cpu")
    _compare(got, want)
    feats, poss, boxes = (t.numpy() for t in got)
    assert feats.shape == (2, 7, 2048) and poss.shape == (2, 7, 95)
    assert boxes.shape == (2, 6, 4)
    np.testing.assert_array_equal(poss[:, 0], [[0, 0, 1, 1] + [0] * 91] * 2)
    valid = poss[:, 1:, 4:].max(axis=-1) > 0
    assert valid.any(axis=1).all()                 # every image detects
    # invalid slots are zero; valid rows are [y1/H, y2/H, x1/W, x2/W]
    assert not feats[:, 1:][~valid].any() and not poss[:, 1:][~valid].any()
    h, w = inputs[2][:, 0, None], inputs[2][:, 1, None]
    np.testing.assert_allclose(poss[:, 1:, :4][valid], np.stack(
        [boxes[..., 1] / h, boxes[..., 3] / h, boxes[..., 0] / w,
         boxes[..., 2] / w], axis=-1)[valid], rtol=1e-6)


def test_parameters_must_lie_on_the_device(weights, batch_run):
    _, _, tx = weights
    inputs, _ = batch_run
    with pytest.raises(ValueError, match="lie on"):
        TP.extract_features_frcnn(tx, *inputs, device="meta")


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image
    rng = np.random.RandomState(9)
    small = rng.randint(0, 256, (12, 16, 3), np.uint8)
    path = str(tmp_path_factory.mktemp("img") / "street.jpg")
    Image.fromarray(small).resize((150, 110), Image.BILINEAR).save(
        path, quality=92)
    return path


def test_extract_single_image_faster_rcnn_matches_jax(weights, image,
                                                      monkeypatch):
    """800-px square letterbox, 36 detections not halved; the port loads
    its extractor from the weights directory once."""
    wdir, jx, _ = weights
    monkeypatch.setitem(JP._EXTRACTORS, ("frcnn", wdir), jx)
    monkeypatch.setattr(TP, "_EXTRACTORS", {})
    want = JP.extract_single_image(image, image_model="FasterRCNN",
                                   weights_dir=wdir)
    got = TP.extract_single_image(image, image_model="FasterRCNN",
                                  weights_dir=wdir, device="cpu",
                                  max_obj=3, rect=True)  # not for FRCNN
    _compare(got, want)
    feats, poss, boxes = got
    assert feats.shape == (37, 2048) and poss.shape == (37, 95)
    assert boxes.shape == (36, 4)
    assert (poss[1:, 4:].max(axis=-1) > 0).sum() >= 1
    assert list(TP._EXTRACTORS) == [(wdir, "cpu", "FasterRCNN")]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One tiny FRCNN-preset captioner as a JAX (orbax) and a port
    checkpoint of epoch 1, and the vocabulary, under separate paths."""
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
    """One package's demo verb from ``workdir``: its caption line and the
    files it wrote under demo/street/FasterRCNN (images as pixels)."""
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
    out_dir = workdir / "demo" / "street" / "FasterRCNN"
    for name in sorted(os.listdir(out_dir)):
        path = out_dir / name
        files[name] = (np.asarray(Image.open(path)) if name.endswith(".jpg")
                       else path.read_text())
    return caption, files


def test_demo_verb_faster_rcnn_matches_jax(weights, image, checkpoints,
                                           monkeypatch, capsys):
    """The port's greedy demo with the FRCNN preset on the CPU prints the
    JAX demo's caption and writes the same overlays: the detections
    labelled by the argmax of poss[1:, 4:] (label - 1 of 91), and an
    attention overlay per word."""
    wdir, jx, _ = weights
    root, paths = checkpoints
    monkeypatch.setitem(JP._EXTRACTORS, ("frcnn", wdir), jx)
    monkeypatch.setattr(TP, "_EXTRACTORS", {})
    monkeypatch.setenv("ICX_COMPILE_CACHE", "")     # no cache under $HOME
    want_caption, want = _demo(JMAIN.main, paths["jax"], image, wdir, [],
                               [], root / "jax_demo", monkeypatch, capsys)
    got_caption, got = _demo(TMAIN.main, paths["port"], image, wdir,
                             ["--device", "cpu"], [], root / "port_demo",
                             monkeypatch, capsys)
    assert got_caption == want_caption and got_caption
    assert sorted(got) == sorted(want)
    assert got["labels_street.txt"].strip()          # it detected
    assert any(n.startswith("0_") for n in got)
    for name, value in want.items():
        if isinstance(value, str):         # "label x1 y1 x2 y2" per box
            # class names may hold spaces ("traffic light")
            rows = [line.rsplit(" ", 4) for line in value.splitlines()]
            got_rows = [line.rsplit(" ", 4)
                        for line in got[name].splitlines()]
            assert [r[0] for r in got_rows] == [r[0] for r in rows]
            np.testing.assert_allclose(
                np.asarray([r[1:] for r in got_rows], float),
                np.asarray([r[1:] for r in rows], float), atol=1e-3)
        else:
            np.testing.assert_array_equal(got[name], value, name)
