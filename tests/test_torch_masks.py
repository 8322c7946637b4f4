"""The port's mask builders equal the JAX package's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.ops import masks as JM
from image_caption_tpu_torch.ops import masks as TM


def _features():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 6, 5).astype(np.float32)
    x[0, 4:] = 0.0
    x[2] = 0.0                                  # an all-zero item
    x[1, 2, :3] = 0.0                           # partly zero: not pad
    return x


def _tokens():
    return np.array([[1, 5, 7, 2, 0, 0], [1, 0, 3, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0]], np.int32)


CASES = {
    "key_pad_features": (lambda m, x: m.key_pad_mask_from_features(x, 4),
                         _features),
    "key_pad_tokens": (lambda m, x: m.key_pad_mask_from_tokens(x, 5),
                       _tokens),
    "key_pad_tokens_pad3": (
        lambda m, x: m.key_pad_mask_from_tokens(x, 6, pad_idx=3), _tokens),
    "subsequent": (lambda m, x: m.subsequent_mask(3, 6), _tokens),
    "non_pad_features": (lambda m, x: m.non_pad_mask_from_features(x),
                         _features),
    "non_pad_tokens": (lambda m, x: m.non_pad_mask_from_tokens(x), _tokens),
    "combine": (lambda m, x: m.combine_masks(
        m.key_pad_mask_from_tokens(x, 6), m.subsequent_mask(3, 6),
        m.key_pad_mask_from_tokens(x, 6, pad_idx=5)), _tokens),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mask_builder_matches_jax(name):
    build, data = CASES[name]
    x = data()
    want = np.asarray(build(JM, jnp.asarray(x)))
    got = build(TM, torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
