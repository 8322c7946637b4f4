"""The port's per-crop extraction (``extract_features_batch``) against the
JAX package's on a tiny YOLOv5 + ResNet with the same weights: the slot
contract under ``cap_half`` and ``max_obj``, the rectangular letterbox,
both ResNet routes, and the extractor loading."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import ops as JO
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu.vision import yolov5 as JY
from image_caption_tpu_torch.utils.weights import (
    resnet_state_from_jax_params, yolov5_state_from_jax_params)
from image_caption_tpu_torch.vision import ops as TO
from image_caption_tpu_torch.vision import pipeline as TP

from test_torch_resnet import torchvision_state_dict
from test_torch_yolov5 import assert_same_tree, ultralytics_state_dict

CANVAS = 128


@pytest.fixture(scope="module")
def extractors():
    """A tiny extractor (YOLOv5 depth 0.33 width 0.25, ResNet with one
    block per stage) in both packages."""
    jp = JP.ExtractorParams(
        yolo=JY.init_yolov5(jax.random.PRNGKey(0), depth_multiple=0.33,
                            width_multiple=0.25),
        resnet=JR.init_resnet(jax.random.PRNGKey(1), stages=(1, 1, 1, 1)))
    tp = TP.ExtractorParams(yolo=yolov5_state_from_jax_params(jp.yolo),
                            resnet=resnet_state_from_jax_params(jp.resnet))
    return jp, tp


def _square(seed):
    """Two images letterboxed on 128-px canvases (the JAX package's
    letterbox_image), their metas [B, 3] and original sizes."""
    rng = np.random.RandomState(seed)
    canv, metas = [], []
    sizes = ((96, 128), (128, 80))
    for h, w in sizes:
        c, m = JO.letterbox_image(
            jnp.asarray(rng.rand(h, w, 3).astype(np.float32) * 255), CANVAS)
        canv.append(np.asarray(c))
        metas.append(np.asarray(m))
    return np.stack(canv), np.stack(metas), np.asarray(sizes, np.float32)


def _rect(seed):
    """Rectangular-letterbox canvases (content at the top-left, gray
    elsewhere) with metas [B, 5]: the detector masks cells beyond the rect."""
    rng = np.random.RandomState(seed)
    canv, metas, sizes = [], [], ((60, 128), (128, 40))
    for h, w in sizes:
        r, nh, nw, top, left, rh, rw = TO.letterbox_params_rect(h, w, CANVAS)
        c = np.full((CANVAS, CANVAS, 3), 114, np.uint8)
        c[top:top + nh, left:left + nw] = rng.randint(0, 256, (nh, nw, 3))
        canv.append(c)
        metas.append([r, top, left, rh, rw])
    return (np.stack(canv), np.asarray(metas, np.float32),
            np.asarray(sizes, np.float32))


def _compare(got, want):
    gf, gp, gb = (t.numpy() for t in got)
    wf, wp, wb = (np.asarray(t) for t in want)
    assert gf.shape == wf.shape and gp.shape == wp.shape
    np.testing.assert_allclose(gb, wb, atol=1e-3)            # boxes, px
    np.testing.assert_allclose(gp, wp, atol=1e-5)            # positions
    assert np.abs(gf - wf).max() <= 1e-4 * np.abs(wf).max()  # features


@pytest.mark.parametrize("cap_half,max_obj,use_kernel", [
    (True, None, True), (True, 3, True), (False, None, False),
    (False, 2, True)])
def test_extract_features_batch_matches_jax(cap_half, max_obj, use_kernel,
                                            extractors):
    jp, tp = extractors
    canv, metas, sizes = _square(0)
    kw = dict(num_objects=8, crop_size=64, cap_half=cap_half, max_obj=max_obj)
    want = JP.extract_features_batch(jp, jnp.asarray(canv), jnp.asarray(metas),
                                     jnp.asarray(sizes),
                                     compute_dtype=jnp.float32, **kw)
    got = TP.extract_features_batch(tp, canv, metas, sizes,
                                    compute_dtype=torch.float32,
                                    use_kernel=use_kernel, device="cpu", **kw)
    _compare(got, want)
    feats, poss, _ = got
    np.testing.assert_array_equal(poss[:, 0, :4].numpy(), [[0, 0, 1, 1]] * 2)
    assert bool((poss[:, 0, 4:] == 0).all())
    if max_obj is not None:          # two position rows survive
        assert bool((poss[:, 2:] == 0).all())


def test_rect_letterbox_matches_jax(extractors):
    jp, tp = extractors
    canv, metas, sizes = _rect(1)
    kw = dict(num_objects=6, crop_size=64, max_obj=3)
    want = JP.extract_features_batch(jp, jnp.asarray(canv.astype(np.float32)),
                                     jnp.asarray(metas), jnp.asarray(sizes),
                                     compute_dtype=jnp.float32, **kw)
    # the stream hands uint8 canvases; they extract as their float values
    got = TP.extract_features_batch(tp, torch.from_numpy(canv), metas, sizes,
                                    compute_dtype=torch.float32,
                                    device="cpu", **kw)
    _compare(got, want)


def test_bf16_default_runs_close_to_f32(extractors):
    """The default compute dtype is bfloat16, as in the JAX package.  bf16
    detection may pick other boxes, so only slot 0 (the whole image, the
    same crop in both) is compared: within 5% of max|f32|."""
    _, tp = extractors
    canv, metas, sizes = _square(2)
    kw = dict(num_objects=8, crop_size=64, device="cpu")
    f32 = TP.extract_features_batch(tp, canv, metas, sizes,
                                    compute_dtype=torch.float32, **kw)[0]
    bf16 = TP.extract_features_batch(tp, canv, metas, sizes, **kw)[0]
    assert bf16.dtype == torch.float32 and bool(torch.isfinite(bf16).all())
    assert (bf16[:, 0] - f32[:, 0]).abs().max() <= \
        5e-2 * f32[:, 0].abs().max()


@pytest.mark.parametrize("mode,model,sizes,error", [
    ("roi", "YOLOv5", {"roi_trunk_size": 500}, ValueError),
    ("roi", "FasterRCNN", {}, ValueError),
    ("ROI", "YOLOv5", {}, ValueError), ("crop", "yolo", {}, ValueError)])
def test_validate_feature_mode(mode, model, sizes, error):
    with pytest.raises(error):
        TP.validate_feature_mode(mode, model, **sizes)
    TP.validate_feature_mode("crop", "YOLOv5")
    TP.validate_feature_mode("crop", "FasterRCNN")
    TP.validate_feature_mode("roi", "YOLOv5", roi_trunk_size=448,
                             roi_detect_size=320)


def test_parameters_must_lie_on_the_device(extractors):
    _, tp = extractors
    canv, metas, sizes = _square(3)
    with pytest.raises(ValueError, match="lie on"):
        TP.extract_features_batch(tp, canv, metas, sizes, device="meta")


def test_load_extractor_reads_the_weights_dir(extractors, tmp_path, capsys):
    jp, _ = extractors
    sd_y = ultralytics_state_dict(jp.yolo, seed=1)
    sd_r = torchvision_state_dict((1, 1, 1, 1), seed=2)
    np.savez(tmp_path / "yolov5x.npz", **sd_y)
    np.savez(tmp_path / "resnet101.npz", **sd_r)
    got = TP.load_extractor(str(tmp_path), device="cpu")
    assert_same_tree(got.yolo, yolov5_state_from_jax_params(
        JY.import_torch_state_dict(sd_y)))
    assert_same_tree(got.resnet, resnet_state_from_jax_params(
        JR.import_torch_state_dict(sd_r, (1, 1, 1, 1))))
    assert "random" not in capsys.readouterr().out
