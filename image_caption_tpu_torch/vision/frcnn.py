"""Faster R-CNN (ResNet-50-FPN) inference on fixed shapes, batched.

The counterpart of the JAX package's ``vision/frcnn.py``, itself a
re-implementation of torchvision's ``fasterrcnn_resnet50_fpn`` inference
path with every stage on static shapes:

  * ResNet-50 C2-C5 -> FPN P2-P5, and P6 as P5 sampled at stride 2;
  * RPN: a 3x3 conv head, 3 anchors a cell per level (sizes 32..512,
    ratios 0.5/1/2), the top ``pre_nms_per_level`` objectness logits per
    level, one fixed-shape NMS (IoU 0.7) -> ``num_proposals`` boxes;
  * ROIAlign: torchvision's level rule
    ``2 + clip(floor(log2(sqrt(area) / 224 + 1e-6)) + 4 - 2, 0, 3)``;
    every box is resampled on every level and its own level is selected
    (static shapes), as the JAX package computes it;
  * box head fc6/fc7 -> class scores (softmax over 91) and per-class
    deltas, class-aware fixed NMS (score 0.05, IoU 0.5) -> the top
    ``max_det`` detections by score, background dropped, labels 1-based.

Images are letterboxed to a square canvas (800 px) instead of
torchvision's min-800/max-1333 resize, as in the JAX package.  Where the
JAX package maps one image and ``vmap``s it, every function here takes the
batch.  Parameters are nested dicts of tensors in torchvision's layouts:
convs ``{"weight": OIHW, "bias"}``, linears ``{"weight": [out, in],
"bias"}``, fc6's input flattened in torchvision's (C, 7, 7) order.  The
public functions take and return feature maps as NHWC tensors (the JAX
package's layout); the convs run NCHW in ``channels_last`` memory.

Top-k and NMS follow ``jax.lax.top_k``'s tie rule (``topk_lowest_index``,
``nms.nms_fixed``).  The weight import takes both torchvision FPN/RPN
namings (``inner_blocks.{i}.weight`` and ``inner_blocks.{i}.0.weight``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.decoding import topk_lowest_index
from .nms import nms_fixed
from .ops import crop_and_resize
from .resnet import (RESNET50_STAGES, _conv_init, import_torch_state_dict
                     as import_resnet, init_resnet, resnet_feature_maps)

Params = Dict[str, Any]

FPN_DIM = 256
ANCHOR_SIZES = (32, 64, 128, 256, 512)      # per level P2..P6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
NUM_CLASSES = 91                             # background at 0
BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
STRIDES = (4, 8, 16, 32, 64)                 # P2..P6
ROI_SIZE = 7


# ---------------------------------------------------------------------------
# Init (random weights: no checkpoint ships with the repository)
# ---------------------------------------------------------------------------

def _linear_init(gen, cin, cout):
    bound = 1.0 / math.sqrt(cin)
    return {"weight": (torch.rand((cout, cin), generator=gen) * 2 - 1) * bound,
            "bias": (torch.rand(cout, generator=gen) * 2 - 1) * bound}


def _convb_init(gen, k, cin, cout):
    return {"weight": _conv_init(gen, k, cin, cout),
            "bias": torch.zeros(cout)}


def init_frcnn(generator: torch.Generator = None) -> Params:
    """Random CPU float32 parameters from ``generator`` (seed 0 if None):
    the JAX package's ``init_frcnn`` distributions (kaiming-normal convs
    with zero bias, uniform +-1/sqrt(fan_in) linears, identity BN)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    a = len(ANCHOR_RATIOS)
    return {
        "backbone": init_resnet(gen, stages=RESNET50_STAGES),
        "fpn": {
            "inner": [_convb_init(gen, 1, c, FPN_DIM)
                      for c in (256, 512, 1024, 2048)],
            "layer": [_convb_init(gen, 3, FPN_DIM, FPN_DIM)
                      for _ in range(4)],
        },
        "rpn": {
            "conv": _convb_init(gen, 3, FPN_DIM, FPN_DIM),
            "cls": _convb_init(gen, 1, FPN_DIM, a),
            "bbox": _convb_init(gen, 1, FPN_DIM, a * 4),
        },
        "box_head": {
            "fc6": _linear_init(gen, FPN_DIM * ROI_SIZE ** 2, 1024),
            "fc7": _linear_init(gen, 1024, 1024),
            "cls_score": _linear_init(gen, 1024, NUM_CLASSES),
            "bbox_pred": _linear_init(gen, 1024, NUM_CLASSES * 4),
        },
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _convb(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Conv with bias, 'same' padding, on an NHWC tensor -> NHWC; the bias
    is added after the conv, as the JAX package adds it."""
    w = p["weight"]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                 padding=w.shape[-1] // 2)
    return (y + p["bias"].to(x.dtype)[None, :, None, None]).permute(0, 2, 3, 1)


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC nearest resize as ``jax.image.resize(..., "nearest")`` samples:
    output i reads floor((i + 0.5) * in / out), in float32 (not
    ``F.interpolate``'s floor(i * in / out); the two agree at exactly 2x)."""
    for dim, n in ((1, h), (2, w)):
        m = x.shape[dim]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                          * m / n).long().to(x.device)
        x = x.index_select(dim, src)
    return x


def fpn_apply(p: Params, cmaps: List[torch.Tensor]) -> List[torch.Tensor]:
    """C2..C5 [B, h, w, C] -> P2..P5 [B, h, w, 256] and P6 (P5 at stride
    2, torchvision's LastLevelMaxPool with a 1x1 window)."""
    inners = [_convb(pi, c) for pi, c in zip(p["inner"], cmaps)]
    outs: List[torch.Tensor] = [None] * 4
    last = inners[3]
    outs[3] = _convb(p["layer"][3], last)
    for i in (2, 1, 0):
        _, h, w, _ = inners[i].shape
        last = inners[i] + _upsample_nearest(last, h, w)
        outs[i] = _convb(p["layer"][i], last)
    return outs + [outs[3][:, ::2, ::2]]


def _level_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """[h*w*A, 4] xyxy anchors of one level (torchvision AnchorGenerator:
    centres at cell * stride, area size^2, aspect ratios h/w), cell-major
    then anchor."""
    anchors = []
    for ratio in ANCHOR_RATIOS:
        ah = size * math.sqrt(ratio)
        aw = size / math.sqrt(ratio)
        anchors.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = np.asarray(anchors, np.float32)                  # [A, 4]
    ys = np.arange(h, dtype=np.float32) * stride
    xs = np.arange(w, dtype=np.float32) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  weights=BBOX_REG_WEIGHTS) -> torch.Tensor:
    """torchvision BoxCoder.decode: (dx, dy, dw, dh) deltas [..., 4] on xyxy
    boxes [..., 4] (broadcast against each other) -> xyxy boxes."""
    wx, wy, ww, wh = weights
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=math.log(1000.0 / 16))
    dh = torch.clamp(deltas[..., 3] / wh, max=math.log(1000.0 / 16))
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, k], idx [B, M] -> [B, M, k]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------

def rpn_candidates(p: Params, pmaps: List[torch.Tensor], canvas: int, *,
                   pre_nms_per_level: int = 200
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPN maps -> the RPN's NMS input: boxes [B, N, 4] (canvas px,
    clipped) and objectness [B, N] (sigmoid; 0 for boxes narrower than
    1e-3, torchvision's min_size), the top ``pre_nms_per_level`` logits of
    each level, level by level."""
    all_scores, all_boxes = [], []
    for lvl, fm in enumerate(pmaps):
        t = torch.relu(_convb(p["conv"], fm))
        logits = _convb(p["cls"], t)                        # [B, h, w, A]
        b, h, w, _ = logits.shape
        deltas = _convb(p["bbox"], t).reshape(b, -1, 4)
        anchors = torch.from_numpy(_level_anchors(
            h, w, STRIDES[lvl], ANCHOR_SIZES[lvl])).to(fm.device)
        scores = logits.reshape(b, -1)
        k = min(pre_nms_per_level, scores.shape[1])
        top, idx = topk_lowest_index(scores, k)
        boxes = decode_deltas(anchors[idx], _take(deltas, idx))
        all_scores.append(top)
        all_boxes.append(torch.clamp(boxes, 0, canvas))
    scores = torch.sigmoid(torch.cat(all_scores, dim=1))
    boxes = torch.cat(all_boxes, dim=1)
    ok = ((boxes[..., 2] - boxes[..., 0]) > 1e-3) & \
         ((boxes[..., 3] - boxes[..., 1]) > 1e-3)
    return boxes, torch.where(ok, scores, torch.zeros_like(scores))


def rpn_proposals(p: Params, pmaps: List[torch.Tensor], canvas: int, *,
                  pre_nms_per_level: int = 200,
                  num_proposals: int = 256) -> torch.Tensor:
    """FPN maps -> [B, num_proposals, 4] proposal boxes (canvas px; slots
    past the last kept box are zero)."""
    boxes, scores = rpn_candidates(p, pmaps, canvas,
                                   pre_nms_per_level=pre_nms_per_level)
    det = nms_fixed(boxes, scores, torch.zeros_like(scores, dtype=torch.int32),
                    iou_thres=0.7, conf_thres=0.0, max_det=num_proposals,
                    pre_nms=boxes.shape[1])
    return det.boxes


# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------

def roi_levels(boxes: torch.Tensor) -> torch.Tensor:
    """The FPN level (0..3 for P2..P5) of xyxy boxes [..., 4], in float32:
    ``floor(log2(sqrt(area) / 224 + 1e-6)) + 4`` clipped to [2, 5], - 2."""
    area = torch.clamp((boxes[..., 2] - boxes[..., 0])
                       * (boxes[..., 3] - boxes[..., 1]), min=1e-6)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / 224.0 + 1e-6)) + 4
    return torch.clamp(lvl, 2, 5).long() - 2


def roi_align(pmaps: List[torch.Tensor], boxes: torch.Tensor,
              out: int = ROI_SIZE) -> torch.Tensor:
    """MultiScaleRoIAlign over P2..P5 [B, h, w, C] of boxes [B, M, 4]
    (canvas px) -> [B, M, C, out, out]: each box bilinearly resampled
    (``crop_and_resize(method="linear")``) on every level, its own
    level's crop kept."""
    lvl = roi_levels(boxes)
    rois = None
    for i, fm in enumerate(pmaps[:4]):
        crops = crop_and_resize(fm.contiguous(), boxes / STRIDES[i],
                                out_size=out, method="linear")
        rois = crops if rois is None else torch.where(
            (lvl == i)[..., None, None, None], crops, rois)
    return rois.permute(0, 1, 4, 2, 3)


def box_head_apply(p: Params, rois: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROIs [..., C, 7, 7] -> (class logits [..., 91], per-class deltas
    [..., 364]): torchvision's TwoMLPHead and FastRCNNPredictor."""
    x = rois.flatten(-3)
    x = torch.relu(F.linear(x, p["fc6"]["weight"], p["fc6"]["bias"]))
    x = torch.relu(F.linear(x, p["fc7"]["weight"], p["fc7"]["bias"]))
    return (F.linear(x, p["cls_score"]["weight"], p["cls_score"]["bias"]),
            F.linear(x, p["bbox_pred"]["weight"], p["bbox_pred"]["bias"]))


class FrcnnDetections(NamedTuple):
    boxes: torch.Tensor     # [B, max_det, 4] canvas px
    scores: torch.Tensor    # [B, max_det]
    labels: torch.Tensor    # [B, max_det] int32, 1-based (0 = invalid slot)
    valid: torch.Tensor     # [B, max_det] bool


def detection_candidates(p: Params, pmaps: List[torch.Tensor],
                         proposals: torch.Tensor, canvas: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Proposals [B, P, 4] -> the final NMS's input: per-class boxes
    [B, P * 90, 4] (canvas px, clipped), their softmax scores [B, P * 90]
    and labels 1..90, proposal-major."""
    scores, deltas = box_head_apply(p["box_head"], roi_align(pmaps,
                                                             proposals))
    probs = torch.softmax(scores, dim=-1)                   # [B, P, 91]
    b, n = proposals.shape[:2]
    deltas = deltas.reshape(b, n, NUM_CLASSES, 4)[:, :, 1:]
    boxes = torch.clamp(decode_deltas(proposals[:, :, None], deltas),
                        0, canvas)
    labels = torch.arange(1, NUM_CLASSES, dtype=torch.int32,
                          device=proposals.device)
    return (boxes.reshape(b, -1, 4), probs[:, :, 1:].reshape(b, -1),
            labels.repeat(b, n).reshape(b, -1))


def frcnn_detect(params: Params, images: torch.Tensor, *, canvas: int = 800,
                 max_det: int = 36, num_proposals: int = 256,
                 score_thresh: float = 0.05,
                 nms_thresh: float = 0.5) -> FrcnnDetections:
    """[B, canvas, canvas, 3] ImageNet-normalized images -> detections
    with leading dim B, on the images' device and dtype."""
    cmaps = resnet_feature_maps(params["backbone"], images,
                                compute_dtype=images.dtype)
    pmaps = fpn_apply(params["fpn"], cmaps)
    proposals = rpn_proposals(params["rpn"], pmaps, canvas,
                              num_proposals=num_proposals)
    boxes, scores, labels = detection_candidates(params, pmaps, proposals,
                                                 canvas)
    det = nms_fixed(boxes, scores, labels, iou_thres=nms_thresh,
                    conf_thres=score_thresh, max_det=max_det,
                    pre_nms=min(1024, scores.shape[1]))
    return FrcnnDetections(boxes=det.boxes, scores=det.scores,
                           labels=det.classes, valid=det.valid)


def frcnn_detect_single(params: Params, image: torch.Tensor,
                        **kwargs) -> FrcnnDetections:
    """One [canvas, canvas, 3] image -> its detections (the JAX package's
    entry point; ``frcnn_detect``'s options)."""
    det = frcnn_detect(params, image[None], **kwargs)
    return FrcnnDetections(*(t[0] for t in det))


# ---------------------------------------------------------------------------
# torchvision fasterrcnn_resnet50_fpn state_dict import
# ---------------------------------------------------------------------------

def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _imp(sd, name) -> Params:
    """A conv or linear with bias, in its torch layout."""
    w = _t(sd[f"{name}.weight"])
    bias = f"{name}.bias"
    return {"weight": w,
            "bias": _t(sd[bias]) if bias in sd else torch.zeros(w.shape[0])}


def import_torch_state_dict(sd: Dict[str, Any]) -> Params:
    """A torchvision ``fasterrcnn_resnet50_fpn`` state_dict (tensors or
    arrays) -> CPU float32 parameters.  The body's blocks per stage are
    read from its keys (ResNet-50's (3, 4, 6, 3) in a real checkpoint);
    old and new FPN/RPN namings are both taken."""
    body = {k[len("backbone.body."):]: v for k, v in sd.items()
            if k.startswith("backbone.body.")}

    def pick(new, old):
        return new if f"{new}.weight" in sd else old

    fpn = {kind: [_imp(sd, pick(f"backbone.fpn.{kind}_blocks.{i}.0",
                                f"backbone.fpn.{kind}_blocks.{i}"))
                  for i in range(4)]
           for kind in ("inner", "layer")}
    rpn = {"conv": _imp(sd, pick("rpn.head.conv.0.0", "rpn.head.conv")),
           "cls": _imp(sd, "rpn.head.cls_logits"),
           "bbox": _imp(sd, "rpn.head.bbox_pred")}
    box_head = {"fc6": _imp(sd, "roi_heads.box_head.fc6"),
                "fc7": _imp(sd, "roi_heads.box_head.fc7"),
                "cls_score": _imp(sd, "roi_heads.box_predictor.cls_score"),
                "bbox_pred": _imp(sd, "roi_heads.box_predictor.bbox_pred")}
    return {"backbone": import_resnet(body), "fpn": fpn, "rpn": rpn,
            "box_head": box_head}


def load_checkpoint(path: str) -> Params:
    """A torchvision ``.pth`` state_dict or an ``.npz`` of one."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return import_torch_state_dict(dict(z))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torch_state_dict(sd)
