"""The port's Faster R-CNN (``vision/frcnn.py``) against the JAX package's,
function by function, on the same weights (``frcnn_state_from_jax_params``)
at a small size: a ResNet-50 body of one block a stage, full-width FPN and
heads, 256-px canvases, 32 proposals, 6 detections; and the torchvision
state_dict import in both FPN/RPN namings.

Detections and proposals are compared pick by pick: they may differ first
at a pick whose margin over the runner-up (``chip_smoke.pick_margins``, on
the port's NMS input) is below 1e-4, and each test asserts how many picks
were equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pick_margins
from image_caption_tpu.vision import frcnn as JF
from image_caption_tpu.vision import resnet as JR
from image_caption_tpu_torch.utils.weights import frcnn_state_from_jax_params
from image_caption_tpu_torch.vision import frcnn as TF
from image_caption_tpu_torch.vision.resnet import resnet_feature_maps

from test_torch_resnet import torchvision_state_dict
from test_torch_yolov5 import assert_same_tree

CANVAS, PROPOSALS, DETECTIONS = 256, 32, 6
TINY = (1, 1, 1, 1)
MARGIN = 1e-4


def frcnn_torchvision_state_dict(body_stages=TINY, seed=0,
                                 old_names=False):
    """A random torchvision ``fasterrcnn_resnet50_fpn`` state_dict (numpy)
    with a ResNet-50 body of ``body_stages`` blocks, in the new FPN/RPN
    naming (``inner_blocks.{i}.0``, ``rpn.head.conv.0.0``) or the old one.
    ``calibrate_heads`` makes it detect."""
    rng = np.random.RandomState(seed)
    sd = {f"backbone.body.{k}": v for k, v in
          torchvision_state_dict(body_stages, seed=seed + 1).items()}

    def conv(name, co, ci, k):
        sd[f"{name}.weight"] = (rng.randn(co, ci, k, k) * np.sqrt(
            2.0 / (k * k * co))).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(co) * 0.01).astype(np.float32)

    def linear(name, co, ci):
        b = 1.0 / np.sqrt(ci)
        sd[f"{name}.weight"] = rng.uniform(-b, b, (co, ci)).astype(np.float32)
        sd[f"{name}.bias"] = rng.uniform(-b, b, co).astype(np.float32)

    new = "" if old_names else ".0"
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"backbone.fpn.inner_blocks.{i}{new}", 256, c, 1)
        conv(f"backbone.fpn.layer_blocks.{i}{new}", 256, 256, 3)
    conv("rpn.head.conv" + ("" if old_names else ".0.0"), 256, 256, 3)
    conv("rpn.head.cls_logits", 3, 256, 1)
    conv("rpn.head.bbox_pred", 12, 256, 1)
    linear("roi_heads.box_head.fc6", 1024, 256 * 49)
    linear("roi_heads.box_head.fc7", 1024, 1024)
    linear("roi_heads.box_predictor.cls_score", 91, 1024)
    linear("roi_heads.box_predictor.bbox_pred", 364, 1024)
    return sd


def calibrate_heads(sd, seed=0):
    """Scale four heads of ``sd`` (in place) so that random weights behave
    as trained ones, from their outputs on two random 256-px images: the
    RPN's objectness logits to std 1 (as initialised they reach +-100s and
    the sigmoid rounds most of them to exactly 1.0, ties that only the
    index breaks), the box deltas of the RPN to std 0.3 and of the box
    head to std 1 (deltas of tens clip every box to the canvas, and stretch
    rounding errors by their size), and the classifier's logits to std 2
    (as initialised every class scores about 1/91, under the 0.05
    threshold: nothing is detected).  Returns ``sd``."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, CANVAS, CANVAS, 3).astype(np.float32))

    def scale(name, out, std):
        k = np.float32(std / float(out.std()))
        sd[f"{name}.weight"] = sd[f"{name}.weight"] * k
        sd[f"{name}.bias"] = sd[f"{name}.bias"] * k

    tp = TF.import_torch_state_dict(sd)
    pm = TF.fpn_apply(tp["fpn"], resnet_feature_maps(tp["backbone"], x))
    t = [torch.relu(TF._convb(tp["rpn"]["conv"], p)) for p in pm]
    for name, head, std in (("cls_logits", "cls", 1.0),
                            ("bbox_pred", "bbox", 0.3)):
        scale(f"rpn.head.{name}", torch.cat(
            [TF._convb(tp["rpn"][head], u).flatten() for u in t]), std)
    tp = TF.import_torch_state_dict(sd)
    props = TF.rpn_proposals(tp["rpn"], pm, CANVAS,
                             num_proposals=PROPOSALS)
    logits, deltas = TF.box_head_apply(tp["box_head"],
                                       TF.roi_align(pm, props))
    scale("roi_heads.box_predictor.cls_score", logits, 2.0)
    scale("roi_heads.box_predictor.bbox_pred", deltas, 1.0)
    return sd


def jax_import(sd, body_stages=TINY):
    """The JAX package's import of ``sd`` as numpy arrays (its importer
    reads ResNet-50's (3, 4, 6, 3) blocks; ``body_stages`` is patched in)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "RESNET50_STAGES", body_stages)
        return jax.tree_util.tree_map(np.asarray,
                                      JF.import_torch_state_dict(sd))


# per field of a pick: boxes within 1e-3 px, scores 1e-5, the rest exact
PICK_ATOL = {"boxes": 1e-3, "scores": 1e-5, "labels": 0, "valid": 0}


def compare_picks(got, want, margins):
    """``got`` and ``want`` (field -> [K, ...] arrays) pick by pick: the
    first pick that differs must be one whose margin is below ``MARGIN``
    (rounding may decide it), and ends the comparison.  Returns how many
    picks were equal before it."""
    for j, m in enumerate(margins):
        if not all(np.allclose(np.asarray(got[f])[j], np.asarray(w)[j],
                               rtol=0, atol=PICK_ATOL[f])
                   for f, w in want.items()):
            assert m < MARGIN, f"pick {j} differs at margin {m:.3e}"
            return j
    return len(margins)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def nets():
    jp = jax_import(calibrate_heads(frcnn_torchvision_state_dict(seed=0)))
    return jp, frcnn_state_from_jax_params(jp)


@pytest.fixture(scope="module")
def maps(nets):
    """Two normalised 256-px images and the JAX package's C and P maps."""
    jp, _ = nets
    x = np.random.RandomState(1).randn(2, CANVAS, CANVAS, 3).astype(
        np.float32)
    cmaps = JR.resnet_feature_maps(jp["backbone"], jnp.asarray(x))
    pmaps = JF.fpn_apply(jp["fpn"], cmaps)
    return x, [np.asarray(c) for c in cmaps], [np.asarray(p) for p in pmaps]


@pytest.mark.parametrize("h,w,stride,size", [
    (2, 3, 4, 32), (13, 13, 64, 512), (25, 20, 32, 256)])
def test_level_anchors_match_jax(h, w, stride, size):
    np.testing.assert_array_equal(TF._level_anchors(h, w, stride, size),
                                  JF._level_anchors(h, w, stride, size))


def test_decode_deltas_match_jax():
    rng = np.random.RandomState(0)
    anchors = rng.rand(64, 4).astype(np.float32) * 200
    anchors[:, 2:] += anchors[:, :2] + 4
    deltas = (rng.randn(64, 4) * 2).astype(np.float32)
    deltas[::7, 2:] = 80.0                 # past the log(1000/16) clip
    want = np.asarray(JF.decode_deltas(jnp.asarray(anchors),
                                       jnp.asarray(deltas)))
    got = TF.decode_deltas(_t(anchors), _t(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("size_in,size_out", [
    (25, 50), (13, 25), (7, 20), (50, 100), (3, 7)])
def test_upsample_nearest_matches_jax_resize(size_in, size_out):
    """jax.image.resize's nearest samples at half-pixel centres, which
    F.interpolate's nearest does not but at an exact 2x."""
    x = np.random.RandomState(size_in).randn(
        1, size_in, size_in + 2, 4).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, size_out, size_out + 5, 4),
                            "nearest")
    got = TF._upsample_nearest(_t(x), size_out, size_out + 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resnet50_body_maps_match_jax(nets, maps):
    _, tp = nets
    x, cmaps, _ = maps
    got = resnet_feature_maps(tp["backbone"], _t(x))
    for g, w in zip(got, cmaps):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_fpn_apply_matches_jax(nets, maps):
    _, tp = nets
    _, cmaps, pmaps = maps
    got = TF.fpn_apply(tp["fpn"], [_t(c) for c in cmaps])
    assert [tuple(g.shape) for g in got] == [p.shape for p in pmaps]
    assert pmaps[-1].shape[1:3] == (4, 4)                 # P6 = P5 at /2
    for g, w in zip(got, pmaps):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_rpn_proposals_match_jax(nets, maps):
    jp, tp = nets
    _, _, pmaps = maps
    tpm = [_t(p) for p in pmaps]
    got = TF.rpn_proposals(tp["rpn"], tpm, CANVAS,
                           num_proposals=PROPOSALS).numpy()
    boxes, scores = TF.rpn_candidates(tp["rpn"], tpm, CANVAS)
    compared = []
    for i in range(2):
        want = np.asarray(JF.rpn_proposals(
            jp["rpn"], [jnp.asarray(p[i:i + 1]) for p in pmaps], CANVAS,
            num_proposals=PROPOSALS))
        margins = pick_margins(boxes[i], scores[i],
                               torch.zeros_like(scores[i], dtype=torch.int32),
                               PROPOSALS, iou_thres=0.7, conf_thres=0.0,
                               pre_nms=boxes.shape[1])
        compared.append(compare_picks({"boxes": got[i]}, {"boxes": want},
                                      margins))
    assert got.shape == (2, PROPOSALS, 4)
    assert compared == [PROPOSALS, PROPOSALS]
    assert (got[..., 2:] > got[..., :2]).all()            # all kept boxes


def test_roi_align_matches_jax(maps):
    """Boxes of every level (P2..P5 by area) resampled as the JAX package
    resamples them, in torchvision's [M, C, 7, 7] layout."""
    _, _, pmaps = maps
    rng = np.random.RandomState(3)
    sides = np.array([20, 60, 100, 150, 200, 300, 460, 600], np.float32)
    xy = rng.rand(len(sides), 2).astype(np.float32) * 120
    boxes = np.concatenate([xy, xy + sides[:, None]], axis=1)
    levels = TF.roi_levels(_t(boxes)).tolist()
    assert sorted(set(levels)) == [0, 1, 2, 3]
    got = TF.roi_align([_t(p) for p in pmaps], _t(np.stack([boxes] * 2)))
    for i in range(2):
        want = np.asarray(JF.roi_align([jnp.asarray(p[i:i + 1])
                                        for p in pmaps], jnp.asarray(boxes)))
        want = want.transpose(0, 3, 1, 2)
        assert tuple(got[i].shape) == want.shape == (len(sides), 256, 7, 7)
        assert np.abs(got[i].numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


def test_box_head_matches_jax(nets):
    """torchvision's (C, 7, 7) flatten with its fc6 against the JAX
    package's (7, 7, C) flatten with its permuted fc6."""
    jp, tp = nets
    rois = np.random.RandomState(4).rand(5, 7, 7, 256).astype(np.float32)
    want = JF.box_head_apply(jp["box_head"], jnp.asarray(rois))
    got = TF.box_head_apply(tp["box_head"],
                            _t(rois.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.fixture(scope="module")
def detections(nets, maps):
    jp, tp = nets
    x, _, _ = maps
    kw = dict(canvas=CANVAS, max_det=DETECTIONS, num_proposals=PROPOSALS)
    want = [JF.frcnn_detect_single(jp, jnp.asarray(x[i]), **kw)
            for i in range(2)]
    return TF.frcnn_detect(tp, _t(x), **kw), want


def test_frcnn_detect_matches_jax(nets, maps, detections):
    """The batched detector against the JAX package's per-image one: each
    valid detection's box, score and label, pick by pick."""
    _, tp = nets
    x, _, _ = maps
    got, want = detections
    pm = TF.fpn_apply(tp["fpn"], resnet_feature_maps(tp["backbone"], _t(x)))
    props = TF.rpn_proposals(tp["rpn"], pm, CANVAS, num_proposals=PROPOSALS)
    boxes, scores, labels = TF.detection_candidates(tp, pm, props, CANVAS)
    compared = []
    for i in range(2):
        assert bool(got.valid[i].any())
        margins = pick_margins(boxes[i], scores[i], labels[i], DETECTIONS,
                               iou_thres=0.5, conf_thres=0.05, pre_nms=1024)
        compared.append(compare_picks(
            {f: getattr(got, f)[i].numpy() for f in PICK_ATOL},
            want[i]._asdict(), margins))
    assert compared == [DETECTIONS, DETECTIONS]
    assert got.labels.dtype == torch.int32
    assert bool((got.boxes >= 0).all() and (got.boxes <= CANVAS).all())


def test_frcnn_detect_single_is_a_batch_of_one(nets, maps, detections):
    _, tp = nets
    x, _, _ = maps
    one = TF.frcnn_detect_single(tp, _t(x[1]), canvas=CANVAS,
                                 max_det=DETECTIONS,
                                 num_proposals=PROPOSALS)
    batched, _ = detections
    for a, b in zip(one, batched):
        torch.testing.assert_close(a, b[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("old_names", [False, True])
def test_import_state_dict_matches_jax(old_names):
    """One torchvision state_dict with a full ResNet-50 body through both
    importers, in either FPN/RPN naming: the same tree, and the same box
    head outputs."""
    sd = frcnn_torchvision_state_dict(TF.RESNET50_STAGES, seed=5,
                                      old_names=old_names)
    jp = jax_import(sd, TF.RESNET50_STAGES)
    got = TF.import_torch_state_dict(sd)
    assert [len(s) for s in got["backbone"]["layers"]] == [3, 4, 6, 3]
    assert_same_tree(got, frcnn_state_from_jax_params(jp))
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert_same_tree(TF.import_torch_state_dict(torch_sd), got)
    rois = np.random.RandomState(6).rand(3, 7, 7, 256).astype(np.float32)
    want = JF.box_head_apply(jp["box_head"], jnp.asarray(rois))
    out = TF.box_head_apply(got["box_head"],
                            _t(rois.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(out, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_load_checkpoint_npz_and_pth(tmp_path):
    sd = frcnn_torchvision_state_dict(seed=7)
    np.savez(tmp_path / "f.npz", **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "f.pth")
    want = TF.import_torch_state_dict(sd)
    assert_same_tree(TF.load_checkpoint(str(tmp_path / "f.npz")), want)
    assert_same_tree(TF.load_checkpoint(str(tmp_path / "f.pth")), want)


def test_init_matches_the_jax_shapes():
    shapes = jax.eval_shape(JF.init_frcnn, jax.random.PRNGKey(0))
    want = frcnn_state_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    got = TF.init_frcnn(torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: tuple(t.shape), want))
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: tuple(t.shape), got))
    assert flat_g == flat_w
    assert float(got["fpn"]["inner"][0]["bias"].abs().max()) == 0.0
