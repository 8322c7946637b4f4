"""The port's data side against the JAX package's: the synthetic dataset
(same files, same contents from one seed), the train batches (same order
and padding), and the prefetcher and step timer."""

import os
import pickle

import numpy as np
import pytest
import torch

from image_caption_tpu.data import dataset as JD
from image_caption_tpu.data import synthetic as JSYN
from image_caption_tpu_torch.data import dataset as TD
from image_caption_tpu_torch.data import synthetic as TSYN
from image_caption_tpu_torch.data.prefetch import Prefetcher
from image_caption_tpu_torch.utils import io as TIO
from image_caption_tpu_torch.utils.debug import StepTimer

SIZES = {"train": 6, "valid": 3, "test": 2}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The JAX package's and the port's generator from one seed, and the
    port's again with ``.npy`` feature files."""
    root = tmp_path_factory.mktemp("synthetic")
    kw = dict(num_images=SIZES, num_slots=5, dim_features=16,
              dim_positions=12, seed=3)
    vocab_j = JSYN.generate_synthetic_dataset(str(root / "jax"), **kw)
    vocab_t = TSYN.generate_synthetic_dataset(str(root / "port"), **kw)
    vocab_n = TSYN.generate_synthetic_dataset(str(root / "npy"), **kw,
                                              feature_format="npy")
    assert vocab_j == vocab_t == vocab_n
    return root


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _read(path):
    if path.endswith(".hkl"):
        return TIO.load_hkl(path)
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        return pickle.load(f)


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


def test_synthetic_dataset_equals_jax(datasets):
    jax_dir, port_dir = datasets / "jax", datasets / "port"
    files = _files(jax_dir)
    assert files == _files(port_dir)
    assert "coco-val-df.p" in files and "train/word_index.pkl" in files
    for name in files:
        assert _equal(_read(str(jax_dir / name)),
                      _read(str(port_dir / name))), name


def test_npy_features_hold_the_same_arrays(datasets):
    for split in SIZES:
        for kind in ("features", "positions"):
            hkl = TIO.load_hkl(str(datasets / "port" / split /
                                   f"{split}.{kind}.hkl"))
            npy = np.load(datasets / "npy" / split / f"{split}.{kind}.npy")
            np.testing.assert_array_equal(hkl, npy)
    with pytest.raises(ValueError):
        TSYN.generate_synthetic_dataset(str(datasets / "bad"),
                                        feature_format="csv")


@pytest.mark.parametrize("streaming", ["never", "always"])
@pytest.mark.parametrize("source", ["port", "npy"])
def test_load_split_reads_hkl_and_npy(datasets, source, streaming):
    want = JD.load_split(str(datasets / "jax"), "valid", verbose=False,
                         load_references=True)
    got = TD.load_split(str(datasets / source), "valid", verbose=False,
                        load_references=True, streaming=streaming)
    np.testing.assert_array_equal(np.asarray(got.features), want.features)
    np.testing.assert_array_equal(got.features[np.array([2, 0, 2])],
                                  want.features[np.array([2, 0, 2])])
    np.testing.assert_array_equal(got.captions, want.captions)
    assert got.references == want.references


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_caption_batches_equal_jax(datasets, shuffle, drop_remainder):
    jsplit = JD.load_split(str(datasets / "jax"), "train", verbose=False)
    tsplit = TD.load_split(str(datasets / "port"), "train", verbose=False)
    kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop_remainder)
    jb, tb = JD.CaptionBatches(jsplit, 4, **kw), \
        TD.CaptionBatches(tsplit, 4, **kw)
    assert len(tb) == len(jb) == (7 if drop_remainder else 8)
    for epoch in (0, 1, 3):
        got, want = list(tb.epoch(epoch)), list(jb.epoch(epoch))
        assert len(got) == len(want) == len(tb)
        for g, w in zip(got, want):
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
            assert g[3] == w[3]
    last = list(tb)[-1]
    if not drop_remainder:           # 30 captions: the last batch holds 2
        assert last[3] == 2
        np.testing.assert_array_equal(last[2][2:, 1:], 0)
        np.testing.assert_array_equal(last[2][2:, 0], 1)


def test_blank_padded_captions_equals_jax():
    caps = np.arange(24, dtype=np.int32).reshape(4, 6)
    np.testing.assert_array_equal(TD._blank_padded_captions(caps, 2),
                                  JD._blank_padded_captions(caps, 2))
    assert TD._blank_padded_captions(caps, 4) is caps


def test_prefetcher_keeps_order_and_maps_on_its_thread():
    import threading
    seen = []

    def transform(x):
        seen.append(threading.current_thread().name)
        return torch.tensor(x) * 2

    out = [int(t) for t in Prefetcher(range(7), depth=2,
                                      transform=transform)]
    assert out == [0, 2, 4, 6, 8, 10, 12]
    assert threading.current_thread().name not in seen


def test_prefetcher_raises_the_producer_error():
    def items():
        yield 1
        raise KeyError("boom")

    it = iter(Prefetcher(items()))
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_step_timer_leaves_out_the_first_step(monkeypatch):
    clock = iter([5.0, 6.0, 8.0, 10.0])
    monkeypatch.setattr("image_caption_tpu_torch.utils.debug.time"
                        ".perf_counter", lambda: next(clock))
    t = StepTimer()
    assert t.steps_per_sec is None
    t.step()                         # the first step ends at 5 s
    t.step()                         # 6
    t.step(2)                        # 8: a 2-step call
    assert t.steps_per_sec == 3 / (10.0 - 5.0)


def test_save_pickle_and_save_array_round_trip(tmp_path):
    TIO.save_pickle({"a": [1, 2]}, str(tmp_path / "x" / "y.pkl"))
    assert TIO.load_pickle(str(tmp_path / "x" / "y.pkl")) == {"a": [1, 2]}
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for name in ("f.hkl", "f.npy"):
        TIO.save_array(arr, str(tmp_path / name))
        np.testing.assert_array_equal(_read(str(tmp_path / name)), arr)
