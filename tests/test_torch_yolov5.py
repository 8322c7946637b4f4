"""The port's YOLOv5 against the JAX package's, weights carried across with
``yolov5_state_from_jax_params``: raw head outputs (6x6 stem and the v5.0
Focus stem), the anchor decode with the rectangular-letterbox mask,
detections, and the ultralytics state_dict import."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import yolov5 as JY
from image_caption_tpu_torch.utils.weights import yolov5_state_from_jax_params
from image_caption_tpu_torch.vision import yolov5 as TY

yolov5_raw = jax.jit(JY.yolov5_raw,
                     static_argnames=("compute_dtype", "focus_stem",
                                      "s2d_stem"))
TINY = dict(depth_multiple=0.33, width_multiple=0.25)


@pytest.fixture(scope="module")
def nets():
    """Tiny YOLOv5 (depth 0.33, width 0.25) in both packages, with the 6x6
    stem and with the Focus stem."""
    out = {}
    for stem, focus in (("v6", False), ("focus", True)):
        jp = JY.init_yolov5(jax.random.PRNGKey(3), focus_stem=focus, **TINY)
        out[stem] = (jp, yolov5_state_from_jax_params(jp), focus)
    return out


def _images(seed, b=2, size=96):
    return np.random.RandomState(seed).rand(b, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("stem", ["v6", "focus"])
def test_raw_head_matches_jax(stem, nets):
    jp, tp, focus = nets[stem]
    assert TY.stem_is_focus(tp) == JY.stem_is_focus(jp) == focus
    imgs = _images(0)
    want = yolov5_raw(jp, jnp.asarray(imgs), compute_dtype=jnp.float32,
                      focus_stem=focus)
    got = TY.yolov5_raw(tp, torch.from_numpy(imgs), torch.float32,
                        focus_stem=focus)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _raw(seed, b=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, s, s, 255) * 2).astype(np.float32)
            for s in (16, 8, 4)]


@pytest.mark.parametrize("rect", [False, True])
def test_decode_boxes_scores_matches_jax(rect, nets):
    jp, tp, _ = nets["v6"]
    raw = _raw(1)
    rect_hw = np.array([[128.0, 96.0], [64.0, 128.0]], np.float32)
    kw_j = {"rect_hw": jnp.asarray(rect_hw)} if rect else {}
    kw_t = {"rect_hw": torch.from_numpy(rect_hw)} if rect else {}
    wb, ws, wc = JY.decode_boxes_scores(jp, [jnp.asarray(r) for r in raw],
                                        **kw_j)
    gb, gs, gc = TY.decode_boxes_scores(tp, [torch.from_numpy(r)
                                             for r in raw], **kw_t)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gc.dtype == torch.int32


def test_rect_mask_zeroes_cells_beyond_the_rect(nets):
    _, tp, _ = nets["v6"]
    raw = [torch.from_numpy(r[:1]) for r in _raw(2)]
    _, scores, _ = TY.decode_boxes_scores(
        tp, raw, rect_hw=torch.tensor([[40.0, 128.0]]))
    per_scale = torch.split(scores[0], [16 * 16 * 3, 8 * 8 * 3, 4 * 4 * 3])
    for s, (stride, side) in zip(per_scale, ((8, 16), (16, 8), (32, 4))):
        rows = torch.arange(side).repeat_interleave(side * 3)  # cell row
        outside = rows * stride >= 40
        assert bool((s[outside] == 0).all()) and bool((s[~outside] > 0).all())


@pytest.mark.parametrize("stem", ["v6", "focus"])
def test_detect_matches_jax(stem, nets):
    """Classes and validity exact, boxes within 1e-3 px (float32)."""
    jp, tp, focus = nets[stem]
    imgs = _images(4, size=128)
    want = JY.yolov5_detect(jp, jnp.asarray(imgs), max_det=12,
                            focus_stem=focus)
    got = TY.yolov5_detect(tp, torch.from_numpy(imgs), max_det=12,
                           focus_stem=focus)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)


def ultralytics_state_dict(jparams, seed=0, *, prefix="model.",
                           focus=False):
    """A random ultralytics DetectionModel state_dict shaped like the JAX
    params ``jparams`` (numpy values under the real key names)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def convbn(pre, p):
        w = np.asarray(p["conv"]).transpose(3, 2, 0, 1)
        c = w.shape[0]
        sd[f"{pre}.conv.weight"] = (rng.randn(*w.shape) * 0.1).astype(
            np.float32)
        sd[f"{pre}.bn.weight"] = (rng.rand(c) + 0.5).astype(np.float32)
        sd[f"{pre}.bn.bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{pre}.bn.running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{pre}.bn.running_var"] = (rng.rand(c) + 0.5).astype(np.float32)

    for name, idx in JY._LAYER_MAP.items():
        p = jparams[name]
        if name == "b0" and focus:
            convbn(f"{idx}.conv", p)
        elif "m" in p:
            for part in ("cv1", "cv2", "cv3"):
                convbn(f"{idx}.{part}", p[part])
            for i, m in enumerate(p["m"]):
                convbn(f"{idx}.m.{i}.cv1", m["cv1"])
                convbn(f"{idx}.m.{i}.cv2", m["cv2"])
        elif "cv1" in p:
            convbn(f"{idx}.cv1", p["cv1"])
            convbn(f"{idx}.cv2", p["cv2"])
        else:
            convbn(f"{idx}", p)
    for s, conv in enumerate(jparams["detect"]["convs"]):
        k = np.asarray(conv["kernel"])
        sd[f"24.m.{s}.weight"] = (rng.randn(k.shape[3], k.shape[2], 1, 1)
                                  * 0.1).astype(np.float32)
        sd[f"24.m.{s}.bias"] = rng.randn(k.shape[3]).astype(np.float32)
    sd["24.anchors"] = (JY.YOLO_ANCHORS / np.array(
        JY.YOLO_STRIDES, np.float32)[:, None, None] * 1.1).astype(np.float32)
    return {prefix + k: v for k, v in sd.items()}


def assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("stem,prefix", [("v6", "model."), ("focus", "")])
def test_import_state_dict_matches_jax(stem, prefix, nets):
    jp, _, focus = nets[stem]
    sd = ultralytics_state_dict(jp, seed=5, prefix=prefix, focus=focus)
    want = yolov5_state_from_jax_params(JY.import_torch_state_dict(sd))
    got = TY.import_torch_state_dict(sd)
    assert_same_tree(got, want)
    assert TY.stem_is_focus(got) == focus
    # torch tensors as values import the same
    assert_same_tree(TY.import_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}), want)


def test_load_checkpoint_npz_and_torch_file(nets, tmp_path):
    jp, _, _ = nets["v6"]
    sd = ultralytics_state_dict(jp, seed=6)
    np.savez(tmp_path / "y.npz", **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "y.pt")
    want = yolov5_state_from_jax_params(
        JY.load_checkpoint(str(tmp_path / "y.npz")))
    assert_same_tree(TY.load_checkpoint(str(tmp_path / "y.npz")), want)
    assert_same_tree(TY.load_checkpoint(str(tmp_path / "y.pt")), want)


def test_init_matches_the_jax_shapes():
    for focus in (False, True):
        jp = yolov5_state_from_jax_params(
            JY.init_yolov5(jax.random.PRNGKey(0), focus_stem=focus, **TINY))
        tp = TY.init_yolov5(torch.Generator().manual_seed(0),
                            focus_stem=focus, **TINY)
        shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: tuple(x.shape), t)
        assert shapes(tp) == shapes(jp)
    assert TY.yolov5_spec() == JY.yolov5_spec()
