"""The port's batched fixed-shape NMS against the JAX package's ``nms_fixed``
vmapped per image, on the same boxes: the same picks, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import nms as JN
from image_caption_tpu_torch.vision import nms as TN


def _case(seed, b, n, *, ties=False, scale=None, n_classes=5):
    rng = np.random.RandomState(seed)
    scale = np.ones(b) if scale is None else np.asarray(scale, np.float64)
    xy = rng.uniform(0, 600, (b, n, 2)) * scale[:, None, None]
    wh = rng.uniform(10, 120, (b, n, 2)) * scale[:, None, None]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    if ties:                      # many exactly equal scores
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    scores[rng.rand(b, n) < 0.1] = 0.005     # below the conf threshold
    classes = rng.randint(0, n_classes, (b, n)).astype(np.int32)
    return boxes, scores, classes


def _jax(boxes, scores, classes, **kw):
    fn = jax.vmap(lambda bx, sc, cl: JN.nms_fixed(bx, sc, cl, **kw))
    return fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool


@pytest.mark.parametrize("seed,n,pre_nms,max_det,ties", [
    (0, 300, 512, 36, False), (1, 300, 64, 20, False),
    (2, 400, 512, 36, True), (3, 80, 32, 40, True), (4, 1008, 512, 8, False)])
def test_nms_fixed_matches_jax(seed, n, pre_nms, max_det, ties):
    boxes, scores, classes = _case(seed, 3, n, ties=ties)
    kw = dict(iou_thres=0.45, conf_thres=0.01, max_det=max_det,
              pre_nms=pre_nms)
    got = TN.nms_fixed(*map(torch.from_numpy, (boxes, scores, classes)), **kw)
    assert got.boxes.shape == (3, max_det, 4)
    _assert_same(got, _jax(boxes, scores, classes, **kw))


def test_class_offset_span_is_per_image():
    """Image 0 spans a million pixels: a span taken over the batch would
    shift image 1's boxes so far that f32 rounding changes their IoUs."""
    boxes, scores, classes = _case(5, 2, 200, scale=[2000.0, 0.05],
                                   n_classes=30)
    got = TN.nms_fixed(*map(torch.from_numpy, (boxes, scores, classes)),
                       max_det=36)
    _assert_same(got, _jax(boxes, scores, classes, max_det=36))


def test_equal_scores_pick_the_lowest_index_first():
    boxes = np.array([[[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50],
                       [60, 60, 70, 70]]], np.float32)
    scores = np.full((1, 4), 0.5, np.float32)
    classes = np.zeros((1, 4), np.int32)
    got = TN.nms_fixed(*map(torch.from_numpy, (boxes, scores, classes)),
                       max_det=4, pre_nms=4)
    np.testing.assert_array_equal(got.boxes[0].numpy(), boxes[0])
    _assert_same(got, _jax(boxes, scores, classes, max_det=4, pre_nms=4))


def test_suppression_truth_table():
    boxes = np.array([[[0, 0, 10, 10],        # A
                       [1, 1, 11, 11],        # overlaps A: suppressed
                       [20, 20, 30, 30],      # disjoint: kept
                       [0, 0, 10, 10]]],      # A's box, other class: kept
                     np.float32)
    scores = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
    classes = np.array([[0, 0, 0, 1]], np.int32)
    got = TN.nms_fixed(*map(torch.from_numpy, (boxes, scores, classes)),
                       max_det=4, pre_nms=4)
    assert got.valid[0].tolist() == [True, True, True, False]
    np.testing.assert_allclose(got.scores[0, :3].numpy(), [0.9, 0.7, 0.6])


def test_iou_matrix_and_xywh_match_jax():
    rng = np.random.RandomState(6)
    a = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TN.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JN.iou_matrix(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_array_equal(
        TN.xywh_to_xyxy(torch.from_numpy(a)).numpy(),
        np.asarray(JN.xywh_to_xyxy(jnp.asarray(a))))
