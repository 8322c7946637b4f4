"""The port's image ops against the JAX package's: crop-and-resize (Keys
cubic and linear, per-box scale and translation), letterbox geometry and
the unmapping of canvas boxes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import ops as JO
from image_caption_tpu_torch.vision import ops as TO


def _boxes(rng, b, m, h, w):
    """Random xyxy boxes, some reaching past the image, one degenerate."""
    x1 = rng.uniform(-8, w * 0.7, (b, m))
    y1 = rng.uniform(-8, h * 0.7, (b, m))
    x2 = x1 + rng.uniform(2, w * 0.8, (b, m))
    y2 = y1 + rng.uniform(2, h * 0.8, (b, m))
    boxes = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    boxes[0, 0] = [5.0, 7.0, 5.0, 7.0]          # zero size: span floored
    boxes[-1, -1] = [0.0, 0.0, w, h]            # the whole image
    return boxes


@pytest.mark.parametrize("out_size", [16, 37])
@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_crop_and_resize_matches_jax(method, out_size):
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 40, 56, 3) * 255).astype(np.float32)
    boxes = _boxes(rng, 2, 5, 40, 56)
    want = JO.batched_crop_and_resize(jnp.asarray(images), jnp.asarray(boxes),
                                      out_size, method)
    got = TO.crop_and_resize(torch.from_numpy(images), torch.from_numpy(boxes),
                             out_size, method).numpy()
    exact = TO.crop_and_resize(torch.from_numpy(images).double(),
                               torch.from_numpy(boxes), out_size,
                               method).numpy()
    assert got.shape == (2, 5, out_size, out_size, 3)
    # 1e-3 on the 0..255 scale from the same weights applied in float64;
    # JAX's float32 einsum strays up to 2e-3 from that itself, so against
    # JAX the bar is JAX's own error plus 1e-3
    np.testing.assert_allclose(got, exact, atol=1e-3)
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= np.abs(want - exact) + 1e-3)


def test_crop_and_resize_bf16_matches_jax():
    """The pipeline's bf16 resample: weights and image rounded to bf16 on
    both sides; each side rounds its two products once more, so 2% of the
    0..255 range."""
    rng = np.random.RandomState(1)
    images = (rng.rand(2, 32, 48, 3) * 255).astype(np.float32)
    boxes = _boxes(rng, 2, 3, 32, 48)
    want = JO.batched_crop_and_resize(
        jnp.asarray(images).astype(jnp.bfloat16), jnp.asarray(boxes), 24)
    got = TO.crop_and_resize(torch.from_numpy(images).to(torch.bfloat16),
                             torch.from_numpy(boxes), 24)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.02 * 255)


def test_crop_of_the_whole_image_at_its_size_is_the_identity():
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.rand(1, 16, 16, 3).astype(np.float32))
    box = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]])
    for method in ("cubic", "linear"):
        out = TO.crop_and_resize(img, box, 16, method)
        np.testing.assert_allclose(out[0, 0].numpy(), img[0].numpy(),
                                   atol=1e-5)


def test_crop_beyond_the_image_is_zero():
    img = torch.ones(1, 8, 8, 3)
    out = TO.crop_and_resize(img, torch.tensor([[[20.0, 20.0, 30.0, 30.0]]]),
                             4, "linear")
    assert torch.equal(out, torch.zeros_like(out))


def test_unknown_resize_method_raises():
    with pytest.raises(ValueError, match="method"):
        TO.crop_and_resize(torch.zeros(1, 4, 4, 3),
                           torch.zeros(1, 1, 4), 2, "lanczos3")


@pytest.mark.parametrize("h,w,size", [(30, 60, 64), (480, 640, 640),
                                      (640, 427, 640), (1, 1, 32),
                                      (333, 500, 640), (720, 1280, 640)])
def test_letterbox_geometry_matches_jax(h, w, size):
    assert TO.letterbox_params(h, w, size) == JO.letterbox_params(h, w, size)
    assert TO.letterbox_params_rect(h, w, size) == \
        JO.letterbox_params_rect(h, w, size)
    assert TO.letterbox_params_rect(h, w, size, 64) == \
        JO.letterbox_params_rect(h, w, size, 64)


def test_unletterbox_boxes_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(-20, 660, (3, 6, 4)).astype(np.float32)
    metas = np.array([[0.5, 80, 0], [1.25, 0, 37], [2.0, 12, 3]], np.float32)
    oh = np.array([480, 512, 300], np.float32)
    ow = np.array([640, 333, 310], np.float32)
    want = jax.vmap(JO.unletterbox_boxes)(*map(jnp.asarray,
                                               (boxes, metas, oh, ow)))
    got = TO.unletterbox_boxes(*map(torch.from_numpy, (boxes, metas, oh, ow)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
