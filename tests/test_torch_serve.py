"""The port's data layer and ``decode_split`` against the JAX package's: the
same split read from disk, the same decode batches, the same strings."""

import numpy as np
import pytest

from image_caption_tpu.data import dataset as JDS
from image_caption_tpu.data import vocab as JV
from image_caption_tpu.data.synthetic import generate_synthetic_dataset
from image_caption_tpu.train.loop import decode_split as jax_decode_split
from image_caption_tpu_torch.data import dataset as TDS
from image_caption_tpu_torch.data import vocab as TV
from image_caption_tpu_torch.serve import decode_split

from conftest import make_fake_batch
from test_torch_captioner import port_model


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    generate_synthetic_dataset(str(root), num_images={"train": 4, "valid": 7},
                               captions_per_image=2, num_slots=5,
                               dim_features=8, dim_positions=6, max_length=9)
    return str(root)


@pytest.mark.parametrize("split,streaming", [
    ("valid", "never"), ("valid", "always"), ("train", "auto")])
def test_load_split_matches_jax(synthetic_root, split, streaming):
    want = JDS.load_split(synthetic_root, split, verbose=False,
                          load_references=True, streaming=streaming)
    got = TDS.load_split(synthetic_root, split, verbose=False,
                         load_references=True, streaming=streaming)
    assert got.num_images == want.num_images
    assert got.num_captions == want.num_captions
    for name in ("features", "positions"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(getattr(got, name)[[3, 1, 1]],
                                      getattr(want, name)[[3, 1, 1]])
    for name in ("captions", "image_idxs", "file_names"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.word_to_idx == want.word_to_idx
    assert got.references == want.references


def test_load_split_rejects_unknown_streaming_mode(synthetic_root):
    with pytest.raises(ValueError, match="streaming"):
        TDS.load_split(synthetic_root, "valid", streaming="sometimes")


@pytest.mark.parametrize("batch_size", [3, 7, 10])
def test_image_batches_pad_like_jax(synthetic_root, batch_size):
    split = TDS.load_split(synthetic_root, "valid", verbose=False)
    got = list(TDS.ImageBatches(split, batch_size))
    want = list(JDS.ImageBatches(split, batch_size))
    assert len(got) == len(want) == len(TDS.ImageBatches(split, batch_size))
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
        # the padding repeats the batch's row 0
        np.testing.assert_array_equal(g[0][g[3]:], g[0][:1].repeat(
            batch_size - g[3], axis=0))


def test_decode_captions_matches_jax():
    word_to_idx = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3,
                   "a": 4, "dog": 5, "runs": 6}
    idx_to_word = TV.invert_vocab(word_to_idx)
    assert idx_to_word == JV.invert_vocab(word_to_idx)
    tokens = np.array([[1, 4, 5, 6, 2, 5, 0],
                       [1, 0, 4, 0, 5, 0, 0],
                       [4, 1, 5, 3, 6, 6, 6],
                       [1, 2, 4, 4, 4, 4, 4],
                       [0, 0, 0, 0, 0, 0, 0]])
    assert TV.decode_captions(tokens, idx_to_word) == \
        JV.decode_captions(tokens, idx_to_word)
    assert TV.decode_captions(tokens[0], idx_to_word) == ["a dog runs ."]


def _split(cfg, n, seed):
    """An in-memory split of ``n`` images: image 1 all zero, image 4 a copy
    of image 0."""
    f, p, c = make_fake_batch(cfg, batch=n, seed=seed)
    f[1], p[1] = 0.0, 0.0
    f[4], p[4] = f[0], p[0]
    return TDS.CocoSplit(features=f, positions=p, captions=c,
                         image_idxs=np.arange(n),
                         file_names=np.array([f"{i}.jpg" for i in range(n)]))


@pytest.mark.parametrize("beam_size", [None, 3])
@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_decode_split_matches_jax(cfg_name, beam_size, tiny_cfg,
                                  flagship_tiny_cfg):
    cfg = tiny_cfg if cfg_name == "tiny" else flagship_tiny_cfg
    params, model = port_model(cfg, seed=9)
    split = _split(cfg, 7, seed=10)                 # batches of 3, 3 and 1
    idx_to_word = {i: f"w{i}" for i in range(cfg.model.num_vocab)}
    idx_to_word.update({0: "<NULL>", 1: "<START>", 2: "<END>", 3: "<UNK>"})
    want = jax_decode_split(params, cfg, split, 3, idx_to_word,
                            beam_size=beam_size, use_pallas=True)
    got = decode_split(model, cfg, split, 3, idx_to_word,
                       beam_size=beam_size, device="cpu")
    assert got == want
    assert len(got) == 7 and got[4] == got[0]
