"""YOLOv5 detector: CSP backbone, PANet neck, anchor head, fixed-shape NMS.

The counterpart of the JAX package's ``vision/yolov5.py``.  Parameters are
nested dicts of tensors with the JAX package's names, conv kernels in torch
OIHW layout and inference BatchNorm folded into a scale and a bias.  The
published YOLOv5 v6.x architecture (yolov5x: depth x1.33, width x1.25) with
its 6x6 stem, or the v5.0 Focus stem for older checkpoints (a stem kernel
with 12 input channels).  Activations run NCHW in ``channels_last`` memory
through cuDNN; the public functions take and return NHWC tensors, the JAX
package's layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .nms import Detections, nms_fixed

Params = Dict[str, Any]

BN_EPS = 1e-3           # ultralytics BatchNorm2d(eps=1e-3)

# yolov5's COCO anchors per scale (P3/8, P4/16, P5/32), in pixels
YOLO_ANCHORS = np.array([
    [[10, 13], [16, 30], [33, 23]],
    [[30, 61], [62, 45], [59, 119]],
    [[116, 90], [156, 198], [373, 326]],
], np.float32)
YOLO_STRIDES = (8, 16, 32)


def yolov5_spec(depth_multiple: float = 1.33, width_multiple: float = 1.25):
    """(stage repeats, widths, head repeats) of a YOLOv5 scale."""
    def gd(n):
        return max(round(n * depth_multiple), 1)

    def gw(c):
        return int(math.ceil(c * width_multiple / 8) * 8)

    widths = tuple(gw(c) for c in (64, 128, 256, 512, 1024))
    repeats = tuple(gd(n) for n in (3, 6, 9, 3))
    return repeats, widths, gd(3)


# ---------------------------------------------------------------------------
# Init (random weights: no checkpoint ships with the repository)
# ---------------------------------------------------------------------------

def _conv_init(gen, k, cin, cout):
    bound = math.sqrt(1.0 / (k * k * cin))
    return (torch.rand((cout, cin, k, k), generator=gen) * 2 - 1) * bound


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_convbn(gen, k, cin, cout) -> Params:
    return {"conv": _conv_init(gen, k, cin, cout), "bn": _bn_init(cout)}


def _init_c3(gen, cin, cout, n) -> Params:
    ch = cout // 2
    return {"cv1": _init_convbn(gen, 1, cin, ch),
            "cv2": _init_convbn(gen, 1, cin, ch),
            "cv3": _init_convbn(gen, 1, 2 * ch, cout),
            "m": [{"cv1": _init_convbn(gen, 1, ch, ch),
                   "cv2": _init_convbn(gen, 3, ch, ch)} for _ in range(n)]}


def init_yolov5(generator: Optional[torch.Generator] = None, *,
                num_classes: int = 80, depth_multiple: float = 1.33,
                width_multiple: float = 1.25,
                focus_stem: bool = False) -> Params:
    """Random CPU float32 parameters (ultralytics' uniform conv init,
    identity BN, zero detect bias) from ``generator`` (seed 0 if None)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    (n3, n6, n9, n3b), (w64, w128, w256, w512, w1024), hn = yolov5_spec(
        depth_multiple, width_multiple)
    no = 3 * (5 + num_classes)
    p: Params = {
        "b0": _init_convbn(gen, 3 if focus_stem else 6,
                           12 if focus_stem else 3, w64),
        "b1": _init_convbn(gen, 3, w64, w128),
        "b2": _init_c3(gen, w128, w128, n3),
        "b3": _init_convbn(gen, 3, w128, w256),
        "b4": _init_c3(gen, w256, w256, n6),
        "b5": _init_convbn(gen, 3, w256, w512),
        "b6": _init_c3(gen, w512, w512, n9),
        "b7": _init_convbn(gen, 3, w512, w1024),
        "b8": _init_c3(gen, w1024, w1024, n3b),
        "b9": {"cv1": _init_convbn(gen, 1, w1024, w1024 // 2),
               "cv2": _init_convbn(gen, 1, 2 * w1024, w1024)},
        "h10": _init_convbn(gen, 1, w1024, w512),
        "h13": _init_c3(gen, w1024, w512, hn),
        "h14": _init_convbn(gen, 1, w512, w256),
        "h17": _init_c3(gen, w512, w256, hn),
        "h18": _init_convbn(gen, 3, w256, w256),
        "h20": _init_c3(gen, w512, w512, hn),
        "h21": _init_convbn(gen, 3, w512, w512),
        "h23": _init_c3(gen, w1024, w1024, hn),
        "detect": {
            "convs": [{"kernel": _conv_init(gen, 1, c, no),
                       "bias": torch.zeros(no)}
                      for c in (w256, w512, w1024)],
            "anchors": torch.from_numpy(YOLO_ANCHORS.copy()),
        },
    }
    return p


# ---------------------------------------------------------------------------
# Apply (NCHW in channels_last memory)
# ---------------------------------------------------------------------------

def _chan(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)[None, :, None, None]


def _convbn(p, x, stride=1):
    k = p["conv"].shape[-1]
    # ultralytics Conv: pad k//2 for odd kernels, 2 for the 6x6 v6.0 stem
    pad = k // 2 if k % 2 == 1 else k // 2 - 1
    y = F.conv2d(x, p["conv"].to(x.dtype), stride=stride, padding=pad)
    y = y * _chan(p["bn"]["scale"], y.dtype) + _chan(p["bn"]["bias"], y.dtype)
    return F.silu(y)


def _c3(p, x, shortcut=True):
    y1 = _convbn(p["cv1"], x)
    for m in p["m"]:
        y = _convbn(m["cv2"], _convbn(m["cv1"], y1))
        y1 = y1 + y if shortcut else y
    y2 = _convbn(p["cv2"], x)
    return _convbn(p["cv3"], torch.cat([y1, y2], dim=1))


def _sppf(p, x):
    pools = [_convbn(p["cv1"], x)]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return _convbn(p["cv2"], torch.cat(pools, dim=1))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _focus(x):
    """v5.0 Focus: 2x2 space-to-depth -> 12 channels."""
    return torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                      x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


def yolov5_raw(params: Params, images: torch.Tensor,
               compute_dtype=torch.float32, *,
               focus_stem: bool = False) -> List[torch.Tensor]:
    """images [B, S, S, 3] in [0, 1] -> per-scale head outputs, float32
    [B, H, W, 3*(5+C)].  The head convs run in float32 on operands rounded
    to ``compute_dtype`` (the JAX package's f32 ``preferred_element_type``)."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    if focus_stem:
        x = _convbn(params["b0"], _focus(x), 1)
    else:
        x = _convbn(params["b0"], x, 2)
    x = _convbn(params["b1"], x, 2)
    x = _c3(params["b2"], x)
    x = _convbn(params["b3"], x, 2)
    p3 = _c3(params["b4"], x)                     # /8
    x = _convbn(params["b5"], p3, 2)
    p4 = _c3(params["b6"], x)                     # /16
    x = _convbn(params["b7"], p4, 2)
    x = _c3(params["b8"], x)
    p5 = _sppf(params["b9"], x)                   # /32

    # PANet (the head's C3 blocks have no residual shortcut)
    h10 = _convbn(params["h10"], p5)
    x = torch.cat([_upsample2(h10), p4], dim=1)
    h13 = _c3(params["h13"], x, shortcut=False)
    h14 = _convbn(params["h14"], h13)
    x = torch.cat([_upsample2(h14), p3], dim=1)
    out3 = _c3(params["h17"], x, shortcut=False)  # /8 head
    x = torch.cat([_convbn(params["h18"], out3, 2), h14], dim=1)
    out4 = _c3(params["h20"], x, shortcut=False)  # /16 head
    x = torch.cat([_convbn(params["h21"], out4, 2), h10], dim=1)
    out5 = _c3(params["h23"], x, shortcut=False)  # /32 head

    raw = []
    for feat, conv in zip((out3, out4, out5), params["detect"]["convs"]):
        w = conv["kernel"].to(feat.dtype).float()
        y = F.conv2d(feat.float(), w) + conv["bias"].float()[None, :, None,
                                                             None]
        raw.append(y.permute(0, 2, 3, 1))
    return raw


def decode_boxes_scores(params: Params, raw: Sequence[torch.Tensor], *,
                        num_classes: int = 80, rect_hw=None):
    """Anchor decode for NMS: head outputs -> (boxes_xyxy [B, N, 4],
    scores [B, N], classes [B, N] int32), N = cells x 3 anchors over the
    scales.  score = sigmoid(obj) * sigmoid(max class logit); class = the
    first maximal logit.  ``rect_hw`` [B, 2] zeroes the objectness of cells
    beyond a rectangular-letterbox content region."""
    nc = num_classes
    anchors = params["detect"]["anchors"]
    bs, ss, cs = [], [], []
    for scale, (y, stride) in enumerate(zip(raw, YOLO_STRIDES)):
        b, h, w, _ = y.shape
        y = y.reshape(b, h, w, 3, 5 + nc)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=y.device),
            torch.arange(w, dtype=torch.float32, device=y.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        xy = (torch.sigmoid(y[..., :2]) * 2.0 - 0.5 + grid) * stride
        wh = torch.square(torch.sigmoid(y[..., 2:4]) * 2.0) \
            * anchors[scale].to(y.device)[None, None, None]
        obj = torch.sigmoid(y[..., 4])
        if rect_hw is not None:
            in_rect = ((gy * stride < rect_hw[:, None, None, 0]) &
                       (gx * stride < rect_hw[:, None, None, 1]))
            obj = obj * in_rect[..., None]
        cls_logits = y[..., 5:]
        # the first maximal index, as jnp.argmax
        cls_idx = torch.argmax(cls_logits, dim=-1).to(torch.int32)
        score = obj * torch.sigmoid(cls_logits.amax(dim=-1))
        half = wh * 0.5
        boxes = torch.cat([xy - half, xy + half], dim=-1)
        bs.append(boxes.reshape(b, h * w * 3, 4))
        ss.append(score.reshape(b, h * w * 3))
        cs.append(cls_idx.reshape(b, h * w * 3))
    return torch.cat(bs, dim=1), torch.cat(ss, dim=1), torch.cat(cs, dim=1)


def yolov5_detect(params: Params, images: torch.Tensor, *,
                  conf_thres: float = 0.01, iou_thres: float = 0.45,
                  max_det: int = 36, num_classes: int = 80,
                  focus_stem: bool = False, compute_dtype=torch.float32,
                  rect_hw=None) -> Detections:
    """Batched detection: [B, S, S, 3] in [0, 1] -> Detections (leading dim
    B), the reference's thresholds (conf 0.01, IoU 0.45)."""
    raw = yolov5_raw(params, images, compute_dtype, focus_stem=focus_stem)
    boxes, scores, classes = decode_boxes_scores(
        params, raw, num_classes=num_classes, rect_hw=rect_hw)
    return nms_fixed(boxes, scores, classes, iou_thres=iou_thres,
                     conf_thres=conf_thres, max_det=max_det)


def stem_is_focus(params: Params) -> bool:
    """v5.0 stems convolve 12 space-to-depth channels."""
    return params["b0"]["conv"].shape[1] == 12


# ---------------------------------------------------------------------------
# Ultralytics state_dict import (layer indices of model.model)
# ---------------------------------------------------------------------------

_LAYER_MAP = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9, "h10": 10, "h13": 13, "h14": 14,
    "h17": 17, "h18": 18, "h20": 20, "h21": 21, "h23": 23,
}
_C3 = ("b2", "b4", "b6", "b8", "h13", "h17", "h20", "h23")
_DETECT_IDX = 24


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _fold_bn(sd, pre):
    gamma, beta = _np(sd[f"{pre}.weight"]), _np(sd[f"{pre}.bias"])
    mean, var = _np(sd[f"{pre}.running_mean"]), _np(sd[f"{pre}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": torch.from_numpy(scale),
            "bias": torch.from_numpy(beta - mean * scale)}


def _convbn_sd(sd, pre):
    return {"conv": torch.from_numpy(_np(sd[f"{pre}.conv.weight"]).copy()),
            "bn": _fold_bn(sd, f"{pre}.bn")}


def _c3_sd(sd, pre):
    out = {"cv1": _convbn_sd(sd, f"{pre}.cv1"),
           "cv2": _convbn_sd(sd, f"{pre}.cv2"),
           "cv3": _convbn_sd(sd, f"{pre}.cv3"), "m": []}
    i = 0
    while f"{pre}.m.{i}.cv1.conv.weight" in sd:
        out["m"].append({"cv1": _convbn_sd(sd, f"{pre}.m.{i}.cv1"),
                         "cv2": _convbn_sd(sd, f"{pre}.m.{i}.cv2")})
        i += 1
    return out


def import_torch_state_dict(sd: Dict[str, Any]) -> Params:
    """An ultralytics DetectionModel state_dict (tensors or arrays, keys
    with or without ``model.``) -> CPU float32 parameters; BN folded at
    eps 1e-3; the v5.0 Focus stem detected from its keys or its 12 input
    channels; anchors from the checkpoint (in stride units there) or the
    COCO defaults."""
    sd = {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}
    focus = "0.conv.conv.weight" in sd
    p: Params = {}
    for name, idx in _LAYER_MAP.items():
        if name == "b0" and focus:
            p[name] = _convbn_sd(sd, f"{idx}.conv")
        elif name == "b9":
            p[name] = {"cv1": _convbn_sd(sd, f"{idx}.cv1"),
                       "cv2": _convbn_sd(sd, f"{idx}.cv2")}
        elif name in _C3:
            p[name] = _c3_sd(sd, f"{idx}")
        else:
            p[name] = _convbn_sd(sd, f"{idx}")
    convs = [{"kernel": torch.from_numpy(
                  _np(sd[f"{_DETECT_IDX}.m.{s}.weight"]).copy()),
              "bias": torch.from_numpy(_np(sd[f"{_DETECT_IDX}.m.{s}.bias"]))}
             for s in range(3)]
    key = f"{_DETECT_IDX}.anchors"
    anchors = (_np(sd[key]) * np.asarray(YOLO_STRIDES, np.float32)[:, None,
                                                                   None]
               if key in sd else YOLO_ANCHORS.copy())
    p["detect"] = {"convs": convs, "anchors": torch.from_numpy(anchors)}
    return p


def load_checkpoint(path: str) -> Params:
    """YOLOv5 weights from an ``.npz`` export or a torch file holding a
    state_dict (or ``{"model": module}``; a raw ultralytics ``.pt`` needs
    its repository to unpickle)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return import_torch_state_dict(dict(z))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return import_torch_state_dict(sd)
