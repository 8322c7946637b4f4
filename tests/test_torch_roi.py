"""The port's shared-trunk extraction (``feature_mode="roi"``) against the
JAX package's on a tiny YOLOv5 + ResNet with the same weights, and its
building blocks: the antialiased ``resize`` and ``letterbox_image``
against ``jax.image.resize``, and ``resnet_feature_maps``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import ops as JO
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu_torch.vision import ops as TO
from image_caption_tpu_torch.vision import pipeline as TP
from image_caption_tpu_torch.vision import resnet as TR

from test_torch_etl import tiny_extractor

CANVAS = 128


@pytest.fixture(scope="module")
def extractors():
    """A tiny extractor (YOLOv5 depth 0.33 width 0.25, ResNet with one
    block per stage) in both packages."""
    return tiny_extractor(4)


def _canvases(seed, n=2):
    """``n`` images letterboxed on 128-px canvases, metas [n, 3], sizes."""
    rng = np.random.RandomState(seed)
    sizes = ((96, 128), (128, 80), (70, 128))[:n]
    canv, metas = [], []
    for h, w in sizes:
        c, m = TO.letterbox_image(rng.rand(h, w, 3).astype(np.float32) * 255,
                                  CANVAS)
        canv.append(c.numpy())
        metas.append(m.numpy())
    return np.stack(canv), np.stack(metas), np.asarray(sizes, np.float32)


# upscales and downscales; at these sizes jax.image.resize on the CPU sums
# within 1e-3 of its own weights' exact result (at some others, e.g.
# 700x400 -> 640x366, it is 2.9e-3 off, test_resize_matches_float64)
@pytest.mark.parametrize("h,w,oh,ow", [
    (48, 64, 480, 640), (240, 320, 480, 640), (37, 53, 100, 80),
    (480, 640, 240, 320), (1024, 683, 640, 427), (120, 90, 17, 33)])
def test_resize_matches_jax(h, w, oh, ow):
    x = (np.random.RandomState(h + ow).rand(h, w, 3) * 255).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (oh, ow, 3),
                                       "bilinear"))
    got = TO.resize(torch.from_numpy(x), oh, ow).numpy()
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("h,w,oh,ow", [(700, 400, 640, 366),
                                       (96, 128, 480, 640)])
def test_resize_matches_float64(h, w, oh, ow):
    """The float32 resize against the same weights summed in float64."""
    x = torch.from_numpy((np.random.RandomState(1).rand(h, w, 3) * 255
                          ).astype(np.float32))
    got = TO.resize(x, oh, ow)
    want = TO.resize(x.double(), oh, ow)
    assert (got.double() - want).abs().max().item() <= 1e-4


def test_resize_upscale_is_plain_bilinear():
    """On an upscale antialiasing changes nothing: the resize is
    crop_and_resize over the whole image (JAX's scale_and_translate
    without antialiasing)."""
    x = torch.from_numpy((np.random.RandomState(2).rand(1, 30, 30, 3)
                          * 255).astype(np.float32))
    got = TO.resize(x, 90, 90)
    want = TO.crop_and_resize(x, torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]),
                              90, method="linear")[:, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,w", [(96, 128), (300, 500), (1000, 37),
                                 (640, 640)])
def test_letterbox_image_matches_jax(h, w):
    x = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.float32)
    wc, wm = JO.letterbox_image(jnp.asarray(x), 640)
    gc, gm = TO.letterbox_image(x, 640)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gc.dtype == torch.float32 and gc.shape == (640, 640, 3)
    assert np.abs(gc.numpy() - np.asarray(wc)).max() <= 1e-3


def test_resnet_feature_maps_match_jax(extractors):
    jp, tp = extractors
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    want = JR.resnet_feature_maps(jp.resnet, jnp.asarray(x))
    got = TR.resnet_feature_maps(tp.resnet, torch.from_numpy(x))
    assert len(got) == 4
    for g, w, stride in zip(got, want, (4, 8, 16, 32)):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 64 // stride, 64 // stride,
                                      g.shape[-1])
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("detect_size,max_obj", [(None, None), (None, 3),
                                                 (32, None), (32, 3)])
def test_extract_features_roi_matches_jax(detect_size, max_obj, extractors):
    jp, tp = extractors
    canv, metas, sizes = _canvases(0)
    kw = dict(num_objects=8, max_obj=max_obj, trunk_size=64,
              detect_size=detect_size)
    want = JP.extract_features_roi(jp, jnp.asarray(canv), jnp.asarray(metas),
                                   jnp.asarray(sizes),
                                   compute_dtype=jnp.float32, **kw)
    got = TP.extract_features_roi(tp, canv, metas, sizes,
                                  compute_dtype=torch.float32, device="cpu",
                                  **kw)
    (gf, gp, gb), (wf, wp, wb) = ([t.numpy() for t in got],
                                  [np.asarray(t) for t in want])
    assert gf.shape == wf.shape == (2, 9, 2048) and gp.shape == wp.shape
    np.testing.assert_allclose(gb, wb, atol=1e-3)            # boxes, px
    np.testing.assert_allclose(gp, wp, atol=1e-5)            # positions
    assert np.abs(gf - wf).max() <= 1e-4 * np.abs(wf).max()


def test_roi_detection_equals_crop_mode_at_full_resolution(extractors):
    """At detect_size == the canvas, detection and slot selection are crop
    mode's: positions and boxes equal bit for bit, slot 0 is filled."""
    _, tp = extractors
    canv, metas, sizes = _canvases(1, n=3)
    kw = dict(num_objects=8, max_obj=3, device="cpu",
              compute_dtype=torch.float32)
    rf, rp, rb = TP.extract_features_roi(tp, canv, metas, sizes,
                                         trunk_size=64, **kw)
    _, cp, cb = TP.extract_features_batch(tp, canv, metas, sizes,
                                          crop_size=64, **kw)
    assert torch.equal(rp, cp) and torch.equal(rb, cb)
    assert bool((rf[:, 0].abs().sum(-1) > 0).all())


def test_roi_identical_canvases_give_identical_features(extractors):
    _, tp = extractors
    canv, metas, sizes = _canvases(2, n=1)
    rep = [np.repeat(a, 3, 0) for a in (canv, metas, sizes)]
    f, p, b = TP.extract_features_roi(tp, *rep, num_objects=8,
                                      trunk_size=64, detect_size=64,
                                      device="cpu")
    for t in (f, p, b):
        assert torch.equal(t[0], t[1]) and torch.equal(t[0], t[2])


@pytest.mark.parametrize("sizes", [{"trunk_size": 100},
                                   {"detect_size": 48},
                                   {"trunk_size": 0}])
def test_roi_sizes_must_be_multiples_of_32(sizes, extractors):
    _, tp = extractors
    canv, metas, orig = _canvases(3, n=1)
    with pytest.raises(ValueError, match="multiple of 32"):
        TP.extract_features_roi(tp, canv, metas, orig, num_objects=8,
                                device="cpu", **sizes)
