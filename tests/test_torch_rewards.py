"""The port's SCST rewards against the JAX package's ``RewardComputer``:
structure scores in corpus-df and frozen-df mode on each scorer, the
native scorer against the Python one, self-CIDEr, ``get_div``, the
n-gram key, and the warning when the native scorer cannot load."""

import os

import numpy as np
import pytest

from image_caption_tpu.rl import rewards as JR
from image_caption_tpu.utils import native as JN
from image_caption_tpu_torch.data.vocab import decode_captions
from image_caption_tpu_torch.metrics.cider import (build_doc_frequency,
                                                   save_doc_frequency)
from image_caption_tpu_torch.ops import _build
from image_caption_tpu_torch.rl import rewards as TR
from image_caption_tpu_torch.utils import native as TN

WORDS = ["a", "man", "dog", "riding", "on", "the", "street", "bike", "red",
         "cat", "sitting", "bench", "two", "birds"]
VOCAB = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
VOCAB.update({w: i + 4 for i, w in enumerate(WORDS)})
T = 12


def _sequences(n, seed):
    """[n, T] token rows over a small vocabulary (shared n-grams), some
    without <END>, one empty, as samples and targets come."""
    rng = np.random.RandomState(seed)
    seq = rng.randint(4, 4 + len(WORDS), size=(n, T))
    for i in range(n):
        end = rng.randint(1, T + 2)
        if end <= T - 1:
            seq[i, end] = 2
            seq[i, end + 1:] = 0
    seq[0, 0] = 2                                   # an empty caption
    return seq


def _df_file(tmp_path):
    idx_to_word = {i: w for w, i in VOCAB.items()}
    groups = [decode_captions(_sequences(5, s), idx_to_word)
              for s in range(20, 30)]
    path = os.path.join(str(tmp_path), "df.p")
    save_doc_frequency(build_doc_frequency(groups), path)
    return path


@pytest.fixture(scope="module")
def native_lib():
    """The native scorer built from the port's copy of the source."""
    _build.load("ngram_rewards")
    return True


def _pair(df, use_native):
    kw = dict(cider_df=df, use_native=use_native)
    return (TR.RewardComputer(VOCAB, **kw), JR.RewardComputer(VOCAB, **kw))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("mode", ["corpus", "frozen"])
def test_structure_scores_equal_jax(mode, use_native, tmp_path, native_lib):
    df = _df_file(tmp_path) if mode == "frozen" else "corpus"
    port, ref = _pair(df, use_native)
    assert port.backend == ("native" if use_native else "python")
    assert port.uses_frozen_df == ref.uses_frozen_df == (mode == "frozen")
    res, gts = _sequences(16, 1), _sequences(16, 2)
    got = port.structure_scores(res, gts)
    want = ref.structure_scores(res, gts)
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 4               # the scores say something


@pytest.mark.parametrize("mode", ["corpus", "frozen"])
def test_native_equals_python(mode, tmp_path, native_lib):
    df = _df_file(tmp_path) if mode == "frozen" else "corpus"
    native = TR.RewardComputer(VOCAB, cider_df=df)
    python = TR.RewardComputer(VOCAB, cider_df=df, use_native=False)
    for seed in (3, 5):
        res, gts = _sequences(12, seed), _sequences(12, seed + 1)
        np.testing.assert_allclose(native.structure_scores(res, gts),
                                   python.structure_scores(res, gts),
                                   rtol=1e-5, atol=1e-6)


def test_self_cider_scores(tmp_path, native_lib):
    df = _df_file(tmp_path)
    port, ref = _pair(df, True)
    seq = _sequences(9, 7)
    ones = port.self_cider_scores(seq, group_size=1)
    assert ones.dtype == np.float32 and np.array_equal(ones, np.zeros(9))
    # the native single-caption scorer agrees: a 1x1 gram gives 0
    np.testing.assert_array_equal(
        port._native.self_cider_scores(port.decode(seq)), np.zeros(9))
    got = port.self_cider_scores(seq, group_size=3)
    want = ref.self_cider_scores(seq, group_size=3)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (9,) and np.all(got[:3] == got[0])
    assert np.count_nonzero(got) > 0
    with pytest.raises(ValueError, match="divisible"):
        port.self_cider_scores(seq, group_size=4)


@pytest.mark.parametrize("eig", [
    [0.0, 0.0], [1.0], [0.0, 1.0], [1.0, 1.0], [0.5, 2.0, 3.0],
    [-1e-9, 0.0, 4.0], [2.0, 0.0], [1e-12, 1e-12, 1e-12]])
def test_get_div_equals_jax(eig):
    eig = np.asarray(eig)
    assert TR.get_div(eig) == JR.get_div(eig)


def test_hash_ngram_equals_jax():
    for gram in [("a",), ("a", "man"), ("riding", "a", "red", "bike"),
                 ("café",), ()]:
        assert TN.hash_ngram(gram) == JN.hash_ngram(gram)


def test_native_load_failure_warns_and_scores_in_python(monkeypatch):
    def broken():
        raise OSError("libngram_rewards: cannot open shared object")

    monkeypatch.setattr(TN, "_load_lib", broken)
    with pytest.warns(RuntimeWarning, match="cannot open shared object"):
        port = TR.RewardComputer(VOCAB, cider_df="corpus")
    assert port.backend == "python"
    res, gts = _sequences(8, 9), _sequences(8, 10)
    python = TR.RewardComputer(VOCAB, cider_df="corpus", use_native=False)
    np.testing.assert_array_equal(port.structure_scores(res, gts),
                                  python.structure_scores(res, gts))


def test_native_library_builds_into_the_build_dir(native_lib):
    path = _build.library_path("ngram_rewards")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libngram_rewards-")
    # the port's copy is the JAX package's source under its own header
    ours = _build.source_path("ngram_rewards").read_text()
    with open(os.path.join(os.path.dirname(JN.__file__), "..", "..", "csrc",
                           "ngram_rewards.cpp")) as f:
        theirs = f.read()
    first = "#include <cmath>"
    assert ours[ours.index(first):] == theirs[theirs.index(first):]


def test_library_hash_covers_sources_headers_and_flags(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "ngram_rewards.cpp").write_text("// scorer\n")
    first = _build.library_path("k"), _build.library_path("ngram_rewards")
    (tmp_path / "common.cuh").write_text("// shared helpers\n")
    with_header = _build.library_path("k")
    assert with_header != first[0]
    # a header changes CUDA libraries only
    assert _build.library_path("ngram_rewards") == first[1]
    (tmp_path / "common.cuh").write_text("// shared helpers, edited\n")
    assert _build.library_path("k") not in (first[0], with_header)
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.library_path("ngram_rewards") != first[1]
