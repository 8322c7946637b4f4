"""The port's offline COCO ETL (``vision/etl.py``) against the JAX
package's: every test of ``tests/test_etl.py`` run on the port, then both
``run_etl`` on one synthetic COCO tree with a tiny extractor carrying the
same weights (caption artifacts equal pickle for pickle, features within
1e-4 x max|ref|, the port's data directory loading in both packages'
datasets)."""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.config import get_preset as jax_preset
from image_caption_tpu.data.dataset import load_split as jax_load_split
from image_caption_tpu.vision import etl as JE
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu.vision import yolov5 as JY
import image_caption_tpu_torch.vision.etl as etl_mod
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.data.dataset import load_split
from image_caption_tpu_torch.data.vocab import build_vocab
from image_caption_tpu_torch.utils.io import save_hkl, save_pickle
from image_caption_tpu_torch.utils.weights import (
    resnet_state_from_jax_params, yolov5_state_from_jax_params)
from image_caption_tpu_torch.vision.etl import (
    build_file_names, build_image_indices, build_references,
    extract_split_features, extract_split_features_resumable,
    process_caption_data)
from image_caption_tpu_torch.vision.pipeline import (ExtractorParams,
                                                     validate_feature_mode)

LEXICON = ("a", "the", "dog", "cat", "man", "woman", "red", "small",
           "sits", "runs", "on", "in", "grass", "street", "table", "near")


def write_coco_tree(root, n_train: int, n_val: int, seed: int = 0,
                    side=(40, 90), captions: int = 5):
    """A COCO-layout tree: ``annotations/captions_{train,val}2017.json``
    with ``captions`` captions an image drawn from a small lexicon (some
    with capitals and punctuation), and ``image/{train,val}2017/`` JPEGs
    with sides drawn from ``side``.  Returns the JPEG paths by split."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = {}
    ann_id = 0
    for split, n, first_id in (("train", n_train, 100), ("val", n_val, 900)):
        image_dir = os.path.join(root, "image", f"{split}2017")
        os.makedirs(image_dir, exist_ok=True)
        images, anns = [], []
        # ids out of file order: the ETL sorts records by image id
        for k, image_id in enumerate(rng.permutation(n) + first_id):
            h, w = rng.randint(side[0], side[1] + 1, size=2)
            small = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3),
                                np.uint8)
            name = f"{split}_{k:04d}.jpg"
            Image.fromarray(small).resize((int(w), int(h)),
                                          Image.BILINEAR).save(
                os.path.join(image_dir, name), quality=90)
            images.append({"id": int(image_id), "file_name": name})
            for _ in range(captions):
                words = list(rng.choice(LEXICON, rng.randint(4, 9)))
                words[0] = words[0].capitalize()
                text = " ".join(words) + rng.choice([".", " .", "", "!"])
                if rng.rand() < 0.3:
                    text = text.replace(" on ", ", on ")
                anns.append({"id": ann_id, "image_id": int(image_id),
                             "caption": text})
                ann_id += 1
        paths[split] = [os.path.join(image_dir, im["file_name"])
                        for im in images]
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return paths


# jitted once: the JAX inits' op-by-op dispatch dominates otherwise
init_yolov5 = jax.jit(JY.init_yolov5,
                      static_argnames=("depth_multiple", "width_multiple"))
init_resnet = jax.jit(JR.init_resnet, static_argnames=("stages",))


def tiny_extractor(seed: int = 0):
    """A tiny YOLOv5 (depth 0.33, width 0.25) and ResNet (one block a
    stage) in both packages, the same weights."""
    jx = JP.ExtractorParams(
        yolo=init_yolov5(jax.random.PRNGKey(seed), depth_multiple=0.33,
                         width_multiple=0.25),
        resnet=init_resnet(jax.random.PRNGKey(seed + 1),
                           stages=(1, 1, 1, 1)))
    tx = ExtractorParams(yolo=yolov5_state_from_jax_params(jx.yolo),
                         resnet=resnet_state_from_jax_params(jx.resnet))
    return jx, tx


def port_extractor(seed: int = 0):
    """A tiny port extractor from torch.Generator ``seed`` (no JAX)."""
    from image_caption_tpu_torch.vision.resnet import init_resnet
    from image_caption_tpu_torch.vision.yolov5 import init_yolov5
    gen = torch.Generator().manual_seed(seed)
    return ExtractorParams(
        yolo=init_yolov5(gen, depth_multiple=0.33, width_multiple=0.25),
        resnet=init_resnet(gen, stages=(1, 1, 1, 1)))


@pytest.fixture()
def coco_json(tmp_path):
    coco = {
        "images": [
            {"id": 7, "file_name": "img7.jpg"},
            {"id": 3, "file_name": "img3.jpg"},
        ],
        "annotations": [
            {"image_id": 7, "caption": "A man, riding his bike."},
            {"image_id": 3, "caption": "Two dogs & a cat (playing)."},
            {"image_id": 7, "caption": "a very " + "long " * 60 + "caption"},
            {"image_id": 3, "caption": "A well-lit room."},
        ],
    }
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(coco))
    return str(path)


def test_process_caption_data(coco_json, tmp_path):
    records = process_caption_data(coco_json, str(tmp_path), max_length=49)
    assert len(records) == 3                     # the long one is dropped
    assert [r["image_id"] for r in records] == [3, 3, 7]
    caps = {r["caption"] for r in records}
    assert "two dogs and a cat playing" in caps
    assert "a well lit room" in caps
    assert "a man riding his bike" in caps
    assert records[0]["file_name"].endswith("img3.jpg")
    assert records == JE.process_caption_data(coco_json, str(tmp_path),
                                              max_length=49)


def test_file_names_indices_and_references(coco_json, tmp_path):
    records = process_caption_data(coco_json, str(tmp_path), max_length=49)
    file_names, id_index = build_file_names(records)
    assert len(file_names) == 2
    assert id_index == {3: 0, 7: 1}
    idxs = build_image_indices(records, id_index)
    np.testing.assert_array_equal(idxs, [0, 0, 1])
    refs = build_references(records)
    assert refs == {0: ["two dogs and a cat playing .", "a well lit room ."],
                    1: ["a man riding his bike ."]}
    jf, ji = JE.build_file_names(records)
    np.testing.assert_array_equal(file_names, jf)
    assert ji == id_index and refs == JE.build_references(records)


def _jpegs(tmp_path, n, seed, stem):
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        img = (rng.rand(40 + 8 * i, 56 + 4 * i, 3) * 255).astype(np.uint8)
        p = str(tmp_path / f"{stem}{i}.jpg")
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def test_extract_split_features_smoke(tmp_path):
    """A tiny random-weight extraction over 3 images through the threaded
    loader and the pipeline end to end."""
    paths = _jpegs(tmp_path, 3, 0, "im")
    tx = port_extractor(0)
    feats, poss = extract_split_features(
        paths, extractor_params=tx, num_objects=4, batch_size=2,
        num_workers=2, verbose=False, device="cpu")
    assert feats.shape == (3, 5, 2048) and poss.shape == (3, 5, 84)
    assert feats.dtype == poss.dtype == np.float32
    assert np.all(np.isfinite(feats))
    np.testing.assert_allclose(poss[:, 0, :4], [[0, 0, 1, 1]] * 3)


@pytest.mark.parametrize("feature_mode", ["crop", "roi"])
def test_extract_split_features_pipelined_ordering(tmp_path, feature_mode):
    """Loading batch k+1, extracting k and draining k-1 put every image's
    features at its own index: against per-image extraction, with a
    ragged last batch and num_workers=1."""
    paths = _jpegs(tmp_path, 5, 1, "om")
    tx = port_extractor(2)
    kw = dict(extractor_params=tx, num_objects=4, verbose=False,
              device="cpu", compute_dtype=torch.float32,
              feature_mode=feature_mode, roi_trunk_size=64,
              roi_detect_size=320)
    feats, poss = extract_split_features(paths, batch_size=2, num_workers=1,
                                         **kw)          # 3 batches
    for i, p in enumerate(paths):
        f1, p1 = extract_split_features([p], batch_size=2, num_workers=2,
                                        **kw)
        np.testing.assert_allclose(feats[i], f1[0], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(poss[i], p1[0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Shard-checkpointed (resumable) extraction
# ---------------------------------------------------------------------------

def _fake_extractor(dim=8, slots=3, fail_after=None):
    """extract_fn stub: features encode the global image index so the
    shard assembly order is checkable; optionally raises after N calls."""
    calls = {"n": 0, "paths": []}

    def extract(paths, verbose=False, **kw):
        calls["n"] += 1
        calls["paths"].append(list(paths))
        if fail_after is not None and calls["n"] > fail_after:
            raise RuntimeError("simulated crash")
        idx = np.asarray([int(p.split("_")[-1]) for p in paths], np.float32)
        feats = np.tile(idx[:, None, None], (1, slots, dim))
        poss = np.tile(idx[:, None, None] * 10, (1, slots, 4))
        return feats, poss

    extract.calls = calls
    return extract


def test_resumable_extraction_kill_resume(tmp_path):
    paths = [f"img_{i}" for i in range(10)]
    out = str(tmp_path)
    crashy = _fake_extractor(fail_after=2)
    with pytest.raises(RuntimeError):
        extract_split_features_resumable(
            paths, out_dir=out, split="train", shard_images=3,
            extract_fn=crashy, verbose=False)
    assert crashy.calls["n"] == 3          # shards 0, 1 done; 2 crashed
    clean = _fake_extractor()
    feats, poss = extract_split_features_resumable(
        paths, out_dir=out, split="train", shard_images=3,
        extract_fn=clean, verbose=False)
    assert clean.calls["n"] == 2           # only shards 2 and 3
    assert clean.calls["paths"][0][0] == "img_6"
    assert feats.shape == (10, 3, 8)
    np.testing.assert_array_equal(feats[:, 0, 0], np.arange(10))
    np.testing.assert_array_equal(poss[:, 0, 0], np.arange(10) * 10)


def test_resumable_manifest_invalidated_on_shape_change(tmp_path):
    out = str(tmp_path)
    first = _fake_extractor()
    extract_split_features_resumable(
        [f"img_{i}" for i in range(6)], out_dir=out, split="valid",
        shard_images=3, extract_fn=first, verbose=False)
    assert first.calls["n"] == 2
    second = _fake_extractor()              # image count changed
    feats, _ = extract_split_features_resumable(
        [f"img_{i}" for i in range(9)], out_dir=out, split="valid",
        shard_images=3, extract_fn=second, verbose=False)
    assert second.calls["n"] == 3
    np.testing.assert_array_equal(feats[:, 0, 0], np.arange(9))


def test_resumable_manifest_invalidated_on_config_change(tmp_path):
    """The same images and shard size under another extraction config
    (crop -> roi, or another compute dtype) re-extract; an unchanged
    config, on another device or ResNet route, resumes."""
    out = str(tmp_path)
    paths = [f"img_{i}" for i in range(6)]

    def run(**kw):
        fake = _fake_extractor()
        extract_split_features_resumable(
            paths, out_dir=out, split="valid", shard_images=3,
            extract_fn=fake, verbose=False, max_obj=5, **kw)
        return fake.calls["n"]

    assert run(feature_mode="crop", compute_dtype=torch.bfloat16) == 2
    assert run(feature_mode="roi", compute_dtype=torch.bfloat16) == 2
    assert run(feature_mode="roi", compute_dtype=torch.bfloat16,
               device="cpu", use_kernel=False, batch_size=7) == 0
    assert run(feature_mode="roi", compute_dtype=torch.float32) == 2
    with pytest.raises(TypeError, match="cannot be fingerprinted"):
        run(feature_mode="roi", generator=torch.Generator())


def test_feature_mode_validated():
    validate_feature_mode("crop")
    validate_feature_mode("roi")
    validate_feature_mode("crop", "FasterRCNN")        # ported
    with pytest.raises(ValueError, match="unknown feature_mode"):
        validate_feature_mode("ROI")
    with pytest.raises(ValueError, match="only implemented for the YOLO"):
        validate_feature_mode("roi", "FasterRCNN")
    validate_feature_mode("roi", roi_trunk_size=448, roi_detect_size=320)
    with pytest.raises(ValueError, match="multiple of 32"):
        validate_feature_mode("roi", roi_detect_size=500)
    with pytest.raises(ValueError, match="multiple of 32"):
        validate_feature_mode("roi", roi_trunk_size=0)


def _seed_split_artifacts(data_path, vocab_captions):
    """Annotation caches of the three splits and a train vocabulary, as a
    completed train ETL leaves them."""
    records = {
        "train": [{"caption": "a dog runs", "image_id": 1,
                   "file_name": "img_0"}],
        "valid": [{"caption": "a cat sits", "image_id": 2,
                   "file_name": "img_1"}],
        "test": [{"caption": "a bird flies", "image_id": 3,
                  "file_name": "img_2"}],
    }
    ann = os.path.join(data_path, "annotations")
    os.makedirs(ann, exist_ok=True)
    for split, recs in records.items():
        save_pickle(recs, os.path.join(ann, f"{split}.annotations.pkl"))
    vocab = build_vocab(vocab_captions, threshold=1)
    save_pickle(vocab, os.path.join(data_path, "train", "word_index.pkl"))
    return vocab


def test_run_etl_valid_only_against_existing_train_artifacts(
        tmp_path, monkeypatch):
    """run_etl(splits=["valid"]) reuses the train pass's vocabulary and
    annotation caches."""
    from image_caption_tpu_torch.utils.io import load_pickle
    data_path = str(tmp_path / "data")
    cfg = get_preset("maxlen49_64").with_overrides(**{
        "data.data_path": data_path})
    vocab = _seed_split_artifacts(data_path, ["a dog runs", "a cat sits",
                                              "a bird flies"])
    monkeypatch.setattr(etl_mod, "extract_split_features_resumable",
                        _fake_extractor())
    monkeypatch.setattr(etl_mod, "load_extractor", lambda w, **kw: None)
    etl_mod.run_etl(cfg, coco_root=str(tmp_path / "nonexistent-coco"),
                    splits=["valid"], device="cpu")
    caps = load_pickle(os.path.join(data_path, "valid", "valid.captions.pkl"))
    assert caps.shape[0] == 1
    assert caps[0][1] == vocab["a"]        # the train vocabulary from disk
    assert os.path.exists(os.path.join(data_path, "coco-val-df.p"))


def test_resumable_manifest_invalidated_on_weights_or_paths_change(
        tmp_path):
    """The manifest fingerprints the extractor's weights and the
    image-path list: new weights or other paths of the same count
    re-extract."""
    out = str(tmp_path)
    paths = [f"img_{i}" for i in range(6)]
    smoke = port_extractor(0)
    real = smoke.to("cpu")                 # a copy of the dicts
    # the first tensor in sorted-name order, which the digest samples
    bn1 = real.resnet["layers"][0][0]["bn1"]
    bn1["bias"] = bn1["bias"] + 1.0

    def run(params, image_paths=paths):
        fake = _fake_extractor()
        extract_split_features_resumable(
            image_paths, out_dir=out, split="valid", shard_images=3,
            extract_fn=fake, verbose=False, extractor_params=params)
        return fake.calls["n"]

    assert run(smoke) == 2
    assert run({"w": np.zeros((4, 4), np.float32)}) == 2
    assert run({"w": np.zeros((4, 4), np.float32)}) == 0
    assert run({"w": np.ones((4, 4), np.float32)}) == 2
    assert run(smoke) == 2
    assert run(real) == 2                  # one sampled tensor moved
    assert run(real) == 0
    assert run(real, [f"other_{i}" for i in range(6)]) == 2


def test_run_etl_refuses_multiprocess(monkeypatch):
    """A torch.distributed launch fails fast on every process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="single-process"):
        etl_mod.run_etl(get_preset("maxlen49_64"), coco_root="/nowhere",
                        device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="single-process"):
        etl_mod.run_etl(get_preset("maxlen49_64"), coco_root="/nowhere",
                        device="cpu")


@pytest.mark.parametrize("feature_format", ["hkl", "npy"])
def test_run_etl_skips_completed_split(tmp_path, monkeypatch,
                                       feature_format):
    """A split whose final feature files exist, with the rows of its
    caption artifacts and this run's fingerprint, is not extracted again;
    other row counts or another config are; a split without a recorded
    fingerprint keeps the row-count skip."""
    data_path = str(tmp_path / "data")
    cfg = get_preset("maxlen49_64").with_overrides(**{
        "data.data_path": data_path})
    _seed_split_artifacts(data_path, ["a cat sits"])
    fake = _fake_extractor()
    monkeypatch.setattr(etl_mod, "extract_split_features_resumable", fake)
    monkeypatch.setattr(etl_mod, "load_extractor", lambda w, **kw: None)

    def run(c=cfg):
        etl_mod.run_etl(c, coco_root="/nowhere", splits=["valid"],
                        feature_format=feature_format, device="cpu")
        return fake.calls["n"]

    feats = os.path.join(data_path, "valid",
                         f"valid.features.{feature_format}")
    assert run() == 1 and os.path.exists(feats)
    assert run() == 1                      # second run: skipped
    stale = np.zeros((3, 2, 8), np.float32)
    if feature_format == "npy":
        np.save(feats, stale)
    else:
        save_hkl(stale, feats)
    assert run() == 2                      # wrong row count
    cfg_roi = cfg.with_overrides(**{"data.feature_mode": "roi"})
    assert run(cfg_roi) == 3               # crop -> roi
    os.remove(os.path.join(data_path, "valid", "valid.features.meta.json"))
    assert run(cfg_roi) == 3               # no fingerprint: row count only


# ---------------------------------------------------------------------------
# run_etl in both packages on one synthetic COCO tree
# ---------------------------------------------------------------------------

CAPTION_ARTIFACTS = (
    "annotations/train.annotations.pkl", "annotations/valid.annotations.pkl",
    "annotations/test.annotations.pkl", "train/word_index.pkl",
    "coco-val-df.p") + tuple(
    f"{s}/{s}.{kind}.pkl" for s in ("train", "valid", "test")
    for kind in ("captions", "file.names", "image.indices", "references"))


@pytest.fixture(scope="module")
def both_etls(tmp_path_factory):
    """``run_etl`` of both packages on 6 train and 4 val JPEGs with a tiny
    extractor of the same weights, batch 4, extraction in float32 in both
    (the JAX package's run_etl has no dtype option, the port's extracts in
    bf16 by default: bf16 rounds differently here and there)."""
    root = tmp_path_factory.mktemp("coco")
    write_coco_tree(str(root), 6, 4, seed=3)
    jx, tx = tiny_extractor(6)
    over = {"model.num_objects": 8}
    out = {}
    jcfg = jax_preset("maxlen49_64").with_overrides(**{
        **over, "data.data_path": str(root / "jax")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "extract_features_batch", functools.partial(
            JP.extract_features_batch, compute_dtype=jnp.float32))
        mp.setattr(JP, "load_extractor", lambda w: jx)
        JE.run_etl(jcfg, coco_root=str(root), batch_size=4)
    out["jax"] = str(root / "jax")
    tcfg = get_preset("maxlen49_64").with_overrides(**{
        **over, "data.data_path": str(root / "port")})
    plain = etl_mod.extract_features_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(etl_mod, "extract_features_batch", lambda *a, **kw: plain(
            *a, **{**kw, "compute_dtype": torch.float32}))
        etl_mod.run_etl(tcfg, coco_root=str(root), batch_size=4,
                        extractor_params=tx, device="cpu")
    out["port"] = str(root / "port")
    return out


def test_run_etl_caption_artifacts_equal_jax(both_etls):
    for rel in CAPTION_ARTIFACTS:
        with open(os.path.join(both_etls["jax"], rel), "rb") as f:
            want = f.read()
        with open(os.path.join(both_etls["port"], rel), "rb") as f:
            got = f.read()
        assert got == want, rel
    refs = pickle.loads(got)
    assert refs and all(len(v) == 5 for v in refs.values())


def test_run_etl_features_match_jax(both_etls):
    from image_caption_tpu.utils.io import load_hkl
    for split, n in (("train", 6), ("valid", 2), ("test", 2)):
        for kind, width in (("features", 2048), ("positions", 84)):
            rel = f"{split}/{split}.{kind}.hkl"
            want = load_hkl(os.path.join(both_etls["jax"], rel))
            got = load_hkl(os.path.join(both_etls["port"], rel))
            assert got.shape == want.shape == (n, 9, width), rel
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        meta = os.path.join(both_etls["port"], split,
                            f"{split}.features.meta.json")
        with open(meta) as f:
            fp = json.load(f)["fingerprint"]
        assert fp["compute_dtype"] == "bfloat16" and "device" not in fp
    assert not os.path.exists(os.path.join(both_etls["port"], "train",
                                           "shards"))


@pytest.mark.parametrize("split", ["train", "valid"])
def test_port_data_directory_loads_in_both_packages(both_etls, split):
    got = load_split(both_etls["port"], split, load_references=True,
                     verbose=False)
    want = jax_load_split(both_etls["port"], split, load_references=True,
                          verbose=False)
    np.testing.assert_array_equal(np.asarray(got.features),
                                  np.asarray(want.features))
    np.testing.assert_array_equal(got.captions, want.captions)
    np.testing.assert_array_equal(got.image_idxs, want.image_idxs)
    assert got.references == want.references
    assert got.num_images == len(got.file_names)
