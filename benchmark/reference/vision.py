"""Plain PyTorch reference of region-feature extraction: JPEG decode and
letterbox, YOLOv5x or Faster R-CNN (ResNet-50-FPN) detection with greedy
class-aware NMS, the slot selection, crop-and-resize and ResNet-101.

The semantics are the system's (the JAX package ``image_caption_tpu``
that the port follows), written from the published architectures:

* YOLOv5 v6 (ultralytics ``models/yolov5x.yaml``, depth 1.33, width 1.25):
  the 6x6 stem, C3 blocks, SPPF, the PANet head, 3 anchors a cell; score =
  sigmoid(objectness) x sigmoid(best class logit), class = the first best;
  NMS over the 512 best candidates above 0.01, IoU 0.45, 36 picks.
* Faster R-CNN ResNet-50-FPN (torchvision ``fasterrcnn_resnet50_fpn``) on a
  square 800-px letterbox, with the system's departures from torchvision:
  unrounded anchors, box deltas weighted (10, 10, 5, 5) in the RPN as in
  the box head, ROI pooling as a 7x7 bilinear resample of each box on its
  level (no sampling grid), P6 as P5 at stride 2; RPN: 200 logits a level,
  NMS 0.7 to 256 proposals; boxes: softmax over 91 classes, scores above
  0.05 among the best 1024, NMS 0.5, 36 picks.
* Crop-and-resize: ``jax.image.scale_and_translate`` with Keys' cubic
  kernel (a = -0.5), no antialiasing, samples outside the image dropped
  and the weights renormalised; 224-px crops of the letterboxed canvas,
  slot 0 the whole content region.
* ResNet-101 (torchvision, v1.5 strides) to the global average pool.

BatchNorm comes folded, as a scale and a bias per channel.  ``prec``
selects how convolutions and matrix products round their operands:
"f32" (TF32 off or on, as the caller sets it), or "fp8" (e4m3 with one
scale per tensor, products accumulated in float32) for the control of a
bf16 configuration.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Leaf(NamedTuple):
    """A parameter to make: its shape and initialiser ("normal" or
    "uniform" times ``scale``, "ones", "zeros", or "const" ``value``)."""
    shape: tuple
    init: str
    scale: float = 1.0
    value: object = None


# ---------------------------------------------------------------------------
# Rounding of operands
# ---------------------------------------------------------------------------

def rounded(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` in float32 after rounding to ``prec``."""
    x = x.float()
    if prec == "fp8":
        s = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s
    return x


def conv(x, w, prec, stride=1, padding=0):
    return F.conv2d(rounded(x, prec), rounded(w, prec), stride=stride,
                    padding=padding)


def matmul(a, b, prec):
    return rounded(a, prec) @ rounded(b, prec)


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def letterbox_geometry(h: int, w: int, size: int):
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    return r, nh, nw, (size - nh) // 2, (size - nw) // 2


def load_canvas(path: str, size: int):
    """A JPEG -> (canvas [size, size, 3] uint8, meta [r, top, left], size
    [h, w]): PIL's bilinear resize of the long side to ``size``, centred on
    gray 114."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        r, nh, nw, top, left = letterbox_geometry(h, w, size)
        small = np.asarray(im.resize((nw, nh), Image.BILINEAR), np.uint8)
    canvas = np.full((size, size, 3), 114, np.uint8)
    canvas[top:top + nh, left:left + nw] = small
    return (canvas, np.asarray([r, top, left], np.float32),
            np.asarray([h, w], np.float32))


def _keys_cubic(d):
    near = ((1.5 * d - 2.5) * d) * d + 1.0
    far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return torch.where(d < 1, near, torch.where(d < 2, far,
                                                torch.zeros_like(d)))


def _triangle(d):
    return (1.0 - d).clamp_min(0.0)


def resample_matrix(lo, hi, in_size: int, out_size: int, kernel):
    """[..., out, in] weights sampling [lo, hi) at ``out_size`` pixel
    centres."""
    span = (hi - lo).clamp_min(1e-3)
    i = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    sample = lo[..., None] + (i + 0.5) * (span / out_size)[..., None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=lo.device)
    w = kernel((sample[..., None] - src).abs())
    total = w.sum(-1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000 * eps, w / torch.where(
        total == 0, torch.ones_like(total), total), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return w * inside[..., None]


def crop_resize(images, boxes, out_size: int, kernel=_keys_cubic,
                prec: str = "f32"):
    """images [B, H, W, C], boxes [B, M, 4] xyxy px -> [B, M, out, out, C]
    float32."""
    b, h, w, c = images.shape
    m = boxes.shape[1]
    boxes = boxes.float()
    wy = resample_matrix(boxes[..., 1], boxes[..., 3], h, out_size, kernel)
    wx = resample_matrix(boxes[..., 0], boxes[..., 2], w, out_size, kernel)
    img = images.float().reshape(b, 1, h, w * c)
    rows = matmul(wy, img, prec).reshape(b, m, out_size, w, c)
    # [B, M, out_y, W, C] -> sum over W with wx [B, M, out_x, W]
    rows = rows.permute(0, 1, 2, 4, 3)               # [B, M, y, C, W]
    out = matmul(rows.reshape(b, m, out_size * c, w), wx.transpose(-1, -2),
                 prec)                              # [B, M, y*C, x]
    return out.reshape(b, m, out_size, c, out_size).permute(0, 1, 2, 4, 3)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalise(x):
    """0..255 NHWC -> ImageNet-normalised NCHW float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

RESNET101 = (3, 4, 23, 3)
RESNET50 = (3, 4, 6, 3)


def resnet_spec(stages: Sequence[int] = RESNET101):
    def cv(k, cin, cout):
        return Leaf((cout, cin, k, k), "normal", math.sqrt(2 / (k * k * cout)))

    def bn(c):
        return {"scale": Leaf((c,), "ones"), "bias": Leaf((c,), "zeros")}

    p = {"stem": {"conv": cv(7, 3, 64), "bn": bn(64)}, "layers": []}
    cin = 64
    for i, n in enumerate(stages):
        wd, cout = 64 * 2 ** i, 256 * 2 ** i
        blocks = []
        for j in range(n):
            c = cin if j == 0 else cout
            blk = {"conv1": cv(1, c, wd), "bn1": bn(wd),
                   "conv2": cv(3, wd, wd), "bn2": bn(wd),
                   "conv3": cv(1, wd, cout), "bn3": bn(cout)}
            if j == 0:
                blk["downsample"] = {"conv": cv(1, c, cout), "bn": bn(cout)}
            blocks.append(blk)
        p["layers"].append(blocks)
        cin = cout
    return p


def _bn(x, p):
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _block(p, x, stride, prec):
    out = torch.relu(_bn(conv(x, p["conv1"], prec), p["bn1"]))
    out = torch.relu(_bn(conv(out, p["conv2"], prec, stride, 1), p["bn2"]))
    out = _bn(conv(out, p["conv3"], prec), p["bn3"])
    if "downsample" in p:
        x = _bn(conv(x, p["downsample"]["conv"], prec, stride),
                p["downsample"]["bn"])
    return torch.relu(out + x)


def resnet_maps(p, x, prec="f32") -> List[torch.Tensor]:
    """NCHW normalised images -> the four stage outputs (NCHW)."""
    x = torch.relu(_bn(conv(x, p["stem"]["conv"], prec, 2, 3), p["stem"]["bn"]))
    x = F.max_pool2d(x, 3, 2, 1)
    maps = []
    for i, blocks in enumerate(p["layers"]):
        for j, blk in enumerate(blocks):
            x = _block(blk, x, 2 if (j == 0 and i > 0) else 1, prec)
        maps.append(x)
    return maps


def resnet_features(p, x, prec="f32", rows: int = 256) -> torch.Tensor:
    """NCHW normalised crops -> [N, 2048] average-pooled features, ``rows``
    crops at a time."""
    return torch.cat([resnet_maps(p, x[s:s + rows], prec)[-1].mean((2, 3))
                      for s in range(0, len(x), rows)])


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def iou(a, b):
    """[N, 4] x [M, 4] xyxy -> [N, M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[:, 2] - t[:, 0]).clamp_min(0) * \
        (t[:, 3] - t[:, 1]).clamp_min(0)                       # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter).clamp_min(1e-9)


class Picks(NamedTuple):
    boxes: torch.Tensor      # [B, D, 4]
    scores: torch.Tensor     # [B, D]
    classes: torch.Tensor    # [B, D] int64
    valid: torch.Tensor      # [B, D] bool


def nms(boxes, scores, classes, *, conf: float, iou_thres: float,
        max_det: int, pre_nms: int) -> Picks:
    """Greedy class-aware NMS per image over the ``pre_nms`` best
    candidates above ``conf`` (best first, the lower index first among
    equal scores); picks padded with zeros to ``max_det``."""
    out = []
    for bx, sc, cl in zip(boxes, scores, classes):
        keep = sc > conf
        idx = torch.nonzero(keep)[:, 0]
        order = torch.sort(sc[idx], descending=True, stable=True).indices
        idx = idx[order][:pre_nms]
        bx, sc, cl = bx[idx], sc[idx], cl[idx]
        over = (iou(bx, bx) > iou_thres) & (cl[:, None] == cl[None])
        alive = torch.ones(len(idx), dtype=torch.bool, device=bx.device)
        picks = []
        over_h, alive_h = over.cpu(), alive.cpu()
        for i in range(len(idx)):
            if len(picks) == max_det:
                break
            if alive_h[i]:
                picks.append(i)
                alive_h &= ~over_h[i]
        sel = torch.tensor(picks, dtype=torch.long, device=bx.device)
        d = len(picks)
        pad = max_det - d
        out.append((F.pad(bx[sel], (0, 0, 0, pad)), F.pad(sc[sel], (0, pad)),
                    F.pad(cl[sel].long(), (0, pad)),
                    torch.arange(max_det, device=bx.device) < d))
    return Picks(*(torch.stack(t) for t in zip(*out)))


# ---------------------------------------------------------------------------
# YOLOv5x
# ---------------------------------------------------------------------------

YOLO_ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119),
                (116, 90, 156, 198, 373, 326))
YOLO_STRIDES = (8, 16, 32)


def yolo_sizes(depth: float, width: float):
    widths = [int(math.ceil(c * width / 8) * 8) for c in (64, 128, 256, 512,
                                                          1024)]
    reps = [max(round(n * depth), 1) for n in (3, 6, 9, 3, 3)]
    return widths, reps


def yolo_spec(depth: float = 1.33, width: float = 1.25,
              num_classes: int = 80):
    (w1, w2, w3, w4, w5), (n1, n2, n3, n4, nh) = yolo_sizes(depth, width)

    def cb(k, cin, cout):
        return {"conv": Leaf((cout, cin, k, k), "uniform",
                             math.sqrt(1 / (k * k * cin))),
                "bn": {"scale": Leaf((cout,), "ones"),
                       "bias": Leaf((cout,), "zeros")}}

    def c3(cin, cout, n):
        h = cout // 2
        return {"cv1": cb(1, cin, h), "cv2": cb(1, cin, h),
                "cv3": cb(1, 2 * h, cout),
                "m": [{"cv1": cb(1, h, h), "cv2": cb(3, h, h)}
                      for _ in range(n)]}

    no = 3 * (5 + num_classes)
    return {
        "b0": cb(6, 3, w1), "b1": cb(3, w1, w2), "b2": c3(w2, w2, n1),
        "b3": cb(3, w2, w3), "b4": c3(w3, w3, n2), "b5": cb(3, w3, w4),
        "b6": c3(w4, w4, n3), "b7": cb(3, w4, w5), "b8": c3(w5, w5, n4),
        "b9": {"cv1": cb(1, w5, w5 // 2), "cv2": cb(1, 2 * w5, w5)},
        "h10": cb(1, w5, w4), "h13": c3(w5, w4, nh), "h14": cb(1, w4, w3),
        "h17": c3(w4, w3, nh), "h18": cb(3, w3, w3), "h20": c3(w4, w4, nh),
        "h21": cb(3, w4, w4), "h23": c3(w5, w5, nh),
        "detect": {"convs": [{"kernel": Leaf((no, c, 1, 1), "uniform",
                                             math.sqrt(1 / c)),
                              "bias": Leaf((no,), "zeros")}
                             for c in (w3, w4, w5)],
                   "anchors": Leaf((3, 3, 2), "const",
                                   value=YOLO_ANCHORS)},
    }


def _cbs(p, x, prec, stride=1, hook=None):
    k = p["conv"].shape[-1]
    y = conv(x, p["conv"], prec, stride, k // 2 if k % 2 else k // 2 - 1)
    if hook is not None:
        hook(p, y)
    return F.silu(_bn(y, p["bn"]))


def _c3(p, x, prec, shortcut, hook):
    a = _cbs(p["cv1"], x, prec, hook=hook)
    for m in p["m"]:
        y = _cbs(m["cv2"], _cbs(m["cv1"], a, prec, hook=hook), prec,
                 hook=hook)
        a = a + y if shortcut else y
    return _cbs(p["cv3"], torch.cat([a, _cbs(p["cv2"], x, prec, hook=hook)],
                                    1), prec, hook=hook)


def yolo_heads(p, images, prec="f32", hook=None) -> List[torch.Tensor]:
    """NHWC images in [0, 1] -> per-scale raw head outputs [B, h, w, 3,
    5 + C].  ``hook(conv_params, pre_bn_output)`` sees every conv before
    its BN (the calibration's)."""
    def cbs(name, x, stride=1):
        return _cbs(p[name], x, prec, stride, hook)

    def c3(name, x, shortcut=True):
        return _c3(p[name], x, prec, shortcut, hook)

    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa
    x = images.permute(0, 3, 1, 2).float()
    x = c3("b2", cbs("b1", cbs("b0", x, 2), 2))
    p3 = c3("b4", cbs("b3", x, 2))
    p4 = c3("b6", cbs("b5", p3, 2))
    x = c3("b8", cbs("b7", p4, 2))
    s = _cbs(p["b9"]["cv1"], x, prec, hook=hook)
    pools = [s]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    p5 = _cbs(p["b9"]["cv2"], torch.cat(pools, 1), prec, hook=hook)
    h10 = cbs("h10", p5)
    h13 = c3("h13", torch.cat([up(h10), p4], 1), False)
    h14 = cbs("h14", h13)
    o3 = c3("h17", torch.cat([up(h14), p3], 1), False)
    o4 = c3("h20", torch.cat([cbs("h18", o3, 2), h14], 1), False)
    o5 = c3("h23", torch.cat([cbs("h21", o4, 2), h10], 1), False)
    heads = []
    for feat, cv in zip((o3, o4, o5), p["detect"]["convs"]):
        y = conv(feat, cv["kernel"], prec) + cv["bias"][None, :, None, None]
        b, _, h, w = y.shape
        heads.append(y.permute(0, 2, 3, 1).reshape(b, h, w, 3, -1))
    return heads


def yolo_candidates(p, heads):
    """Raw heads -> (boxes xyxy [B, N, 4] canvas px, scores [B, N],
    classes [B, N]), cells row-major, 3 anchors a cell, scale by scale."""
    boxes, scores, classes = [], [], []
    anchors = p["detect"]["anchors"].float()
    for y, stride, anc in zip(heads, YOLO_STRIDES, anchors):
        b, h, w = y.shape[:3]
        gy, gx = torch.meshgrid(torch.arange(h, device=y.device),
                                torch.arange(w, device=y.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[None, :, :, None]
        t = torch.sigmoid(y[..., :5])
        xy = (t[..., :2] * 2 - 0.5 + grid) * stride
        wh = (t[..., 2:4] * 2) ** 2 * anc
        best, cls = y[..., 5:].max(-1)
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(b, -1,
                                                                       4))
        scores.append((t[..., 4] * torch.sigmoid(best)).reshape(b, -1))
        classes.append(cls.reshape(b, -1))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(classes, 1)


YOLO_NMS = dict(conf=0.01, iou_thres=0.45, max_det=36, pre_nms=512)


def yolo_detect(p, canvases, prec="f32") -> Picks:
    """uint8 canvases [B, S, S, 3] -> the 36 picks of each."""
    boxes, scores, classes = yolo_candidates(
        p, yolo_heads(p, canvases.float() / 255.0, prec))
    return nms(boxes, scores, classes, **YOLO_NMS)


# ---------------------------------------------------------------------------
# Faster R-CNN ResNet-50-FPN
# ---------------------------------------------------------------------------

FPN = 256
RPN_SIZES = (32, 64, 128, 256, 512)
RPN_RATIOS = (0.5, 1.0, 2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
FRCNN_CLASSES = 91
FRCNN_NMS = dict(conf=0.05, iou_thres=0.5, max_det=36, pre_nms=1024)


def frcnn_spec(trunk_stages: Sequence[int] = RESNET50):
    def convb(k, cin, cout):
        return {"weight": Leaf((cout, cin, k, k), "normal",
                               math.sqrt(2 / (k * k * cout))),
                "bias": Leaf((cout,), "zeros")}

    def lin(cin, cout):
        s = 1 / math.sqrt(cin)
        return {"weight": Leaf((cout, cin), "uniform", s),
                "bias": Leaf((cout,), "uniform", s)}

    a = len(RPN_RATIOS)
    return {"backbone": resnet_spec(trunk_stages),
            "fpn": {"inner": [convb(1, c, FPN) for c in (256, 512, 1024,
                                                         2048)],
                    "layer": [convb(3, FPN, FPN) for _ in range(4)]},
            "rpn": {"conv": convb(3, FPN, FPN), "cls": convb(1, FPN, a),
                    "bbox": convb(1, FPN, 4 * a)},
            "box_head": {"fc6": lin(FPN * 49, 1024), "fc7": lin(1024, 1024),
                         "cls_score": lin(1024, FRCNN_CLASSES),
                         "bbox_pred": lin(1024, 4 * FRCNN_CLASSES)}}


def _convb(p, x, prec):
    k = p["weight"].shape[-1]
    return conv(x, p["weight"], prec, 1, k // 2) + p["bias"][None, :, None,
                                                             None]


def fpn_maps(p, images, prec="f32") -> List[torch.Tensor]:
    """NCHW normalised canvases -> P2..P6 (NCHW)."""
    c = resnet_maps(p["backbone"], images, prec)
    inner = [_convb(q, x, prec) for q, x in zip(p["fpn"]["inner"], c)]
    outs = [None] * 4
    top = inner[3]
    outs[3] = _convb(p["fpn"]["layer"][3], top, prec)
    for i in (2, 1, 0):
        top = inner[i] + F.interpolate(top, size=inner[i].shape[-2:],
                                       mode="nearest")
        outs[i] = _convb(p["fpn"]["layer"][i], top, prec)
    return outs + [outs[3][:, :, ::2, ::2]]


def decode_deltas(anchors, deltas):
    wx, wy, ww, wh = DELTA_WEIGHTS
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = deltas[..., 0] / wx * aw + (anchors[..., 0] + anchors[..., 2]) / 2
    cy = deltas[..., 1] / wy * ah + (anchors[..., 1] + anchors[..., 3]) / 2
    clip = math.log(1000.0 / 16)
    w = torch.exp((deltas[..., 2] / ww).clamp(max=clip)) * aw
    h = torch.exp((deltas[..., 3] / wh).clamp(max=clip)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def level_anchors(h, w, stride, size, device):
    base = []
    for r in RPN_RATIOS:
        ah, aw = size * math.sqrt(r), size / math.sqrt(r)
        base.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = torch.tensor(base, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
    return (shift + base[None]).reshape(-1, 4)


def rpn_proposals(p, maps, canvas: int, prec="f32", per_level=200,
                  proposals=256):
    boxes, scores = [], []
    for lvl, fm in enumerate(maps):
        t = torch.relu(_convb(p["conv"], fm, prec))
        logit = _convb(p["cls"], t, prec).permute(0, 2, 3, 1)
        b, h, w, _ = logit.shape
        delta = _convb(p["bbox"], t, prec).permute(0, 2, 3, 1).reshape(
            b, -1, 4)
        logit = logit.reshape(b, -1)
        top = torch.sort(logit, dim=-1, descending=True, stable=True)
        k = min(per_level, logit.shape[1])
        idx = top.indices[:, :k]
        anc = level_anchors(h, w, FPN_STRIDES[lvl], RPN_SIZES[lvl],
                            fm.device)[idx]
        d = torch.gather(delta, 1, idx[..., None].expand(-1, -1, 4))
        boxes.append(decode_deltas(anc, d).clamp(0, canvas))
        scores.append(top.values[:, :k])
    boxes, scores = torch.cat(boxes, 1), torch.sigmoid(torch.cat(scores, 1))
    ok = ((boxes[..., 2] - boxes[..., 0]) > 1e-3) & \
        ((boxes[..., 3] - boxes[..., 1]) > 1e-3)
    scores = torch.where(ok, scores, torch.zeros_like(scores))
    picks = nms(boxes, scores, torch.zeros_like(scores, dtype=torch.long),
                conf=0.0, iou_thres=0.7, max_det=proposals,
                pre_nms=boxes.shape[1])
    return picks.boxes


def roi_pool(maps, boxes, prec="f32"):
    """P2..P5 (NCHW) and boxes [B, M, 4] -> [B, M, 256 * 49] in (C, 7, 7)
    order, each box on its level."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
            ).clamp_min(1e-6)
    lvl = (torch.floor(torch.log2(area.sqrt() / 224.0 + 1e-6)) + 4).clamp(
        2, 5).long() - 2
    rows = []
    for r in range(len(boxes)):             # one image at a time: P2's
        out = None                          # resample is 0.4 GB an image
        for i, fm in enumerate(maps[:4]):
            crops = crop_resize(fm[r:r + 1].permute(0, 2, 3, 1),
                                boxes[r:r + 1] / FPN_STRIDES[i], 7,
                                _triangle, prec)    # [1, M, 7, 7, C]
            out = crops if out is None else torch.where(
                (lvl[r:r + 1] == i)[..., None, None, None], crops, out)
        rows.append(out)
    return torch.cat(rows).permute(0, 1, 4, 2, 3).flatten(2)


def frcnn_detect(p, canvases, prec="f32", canvas: int = 800) -> Picks:
    """uint8 square canvases -> the 36 picks (labels 1..90)."""
    return nms(*frcnn_candidates(p, canvases, prec, canvas), **FRCNN_NMS)


def frcnn_candidates(p, canvases, prec="f32", canvas: int = 800):
    """uint8 square canvases -> the final NMS's candidates: per-class boxes
    [B, P * 90, 4], their softmax scores and labels 1..90,
    proposal-major."""
    maps = fpn_maps(p, normalise(canvases), prec)
    props = rpn_proposals(p["rpn"], maps, canvas, prec)
    h = p["box_head"]
    x = roi_pool(maps, props, prec)

    def lin(q, t):
        return matmul(t, q["weight"].t(), prec) + q["bias"]
    x = torch.relu(lin(h["fc7"], torch.relu(lin(h["fc6"], x))))
    probs = torch.softmax(lin(h["cls_score"], x), -1)
    b, n = props.shape[:2]
    deltas = lin(h["bbox_pred"], x).reshape(b, n, FRCNN_CLASSES, 4)[:, :, 1:]
    boxes = decode_deltas(props[:, :, None], deltas).clamp(0, canvas)
    labels = torch.arange(1, FRCNN_CLASSES, device=props.device)
    return (boxes.reshape(b, -1, 4), probs[:, :, 1:].reshape(b, -1),
            labels.repeat(b, n).reshape(b, -1))


# ---------------------------------------------------------------------------
# Slots: selection, crops, features and position rows
# ---------------------------------------------------------------------------

def unletterbox(boxes, metas, sizes):
    r, top, left = (metas[:, i, None] for i in range(3))
    oh, ow = sizes[:, 0, None], sizes[:, 1, None]
    x1 = ((boxes[..., 0] - left) / r).clamp_min(0)
    y1 = ((boxes[..., 1] - top) / r).clamp_min(0)
    x2 = ((boxes[..., 2] - left) / r).clamp_min(0)
    y2 = ((boxes[..., 3] - top) / r).clamp_min(0)
    return torch.stack([torch.minimum(x1, ow), torch.minimum(y1, oh),
                        torch.minimum(x2, ow), torch.minimum(y2, oh)], -1)


def content_box(metas, sizes):
    r, top, left = metas[:, 0], metas[:, 1], metas[:, 2]
    return torch.stack([left, top, left + sizes[:, 1] * r,
                        top + sizes[:, 0] * r], -1)


class Slots(NamedTuple):
    crop_boxes: torch.Tensor    # [B, 1 + M, 4] canvas px, slot 0 the image
    crop_valid: torch.Tensor    # [B, 1 + M] bool
    positions: torch.Tensor     # [B, 1 + K, 4 + C]


def yolo_slots(picks: Picks, metas, sizes, num_objects: int, max_obj: int,
               num_classes: int = 80) -> Slots:
    """The system's selection for YOLOv5: the first ``num_objects // 2``
    picks are kept; the ``max_obj`` largest by area (in original pixels;
    the lower slot first among equal areas) are cropped; the position rows
    are the whole image [0, 0, 1, 1] and the largest pick's [x1/W, y1/H,
    x2/W, y2/H] + its score at its class, the rest zero."""
    b, k = picks.valid.shape
    valid = picks.valid & (torch.arange(k, device=metas.device)
                           < num_objects // 2)
    orig = unletterbox(picks.boxes, metas, sizes)
    area = (orig[..., 2] - orig[..., 0]) * (orig[..., 3] - orig[..., 1])
    area = torch.where(valid, area, torch.full_like(area, -1.0))
    top = torch.sort(area, dim=-1, descending=True, stable=True).indices[
        :, :max_obj]
    sel_valid = torch.gather(valid, 1, top)
    sel = torch.gather(picks.boxes, 1, top[..., None].expand(-1, -1, 4))
    crop = torch.cat([content_box(metas, sizes)[:, None], sel], 1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=metas.device)
    oh, ow = sizes[:, 0, None], sizes[:, 1, None]
    i = top[:, 0]
    rows = torch.arange(b, device=metas.device)
    box = orig[rows, i] / torch.cat([ow, oh, ow, oh], 1)
    score = F.one_hot(picks.classes[rows, i].long(), num_classes).float() \
        * picks.scores[rows, i, None]
    pos = torch.zeros((b, num_objects + 1, 4 + num_classes),
                      device=metas.device)
    pos[:, 0, 2:4] = 1.0
    pos[:, 1] = torch.cat([box, score], 1) * sel_valid[:, :1]
    return Slots(crop, torch.cat([ones, sel_valid], 1), pos)


def frcnn_slots(picks: Picks, metas, sizes,
                num_classes: int = FRCNN_CLASSES) -> Slots:
    """Faster R-CNN's slots: every pick cropped; rows [y1/H, y2/H, x1/W,
    x2/W] + its score at label - 1."""
    b = metas.shape[0]
    orig = unletterbox(picks.boxes, metas, sizes)
    oh, ow = sizes[:, 0, None], sizes[:, 1, None]
    box = torch.stack([orig[..., 1] / oh, orig[..., 3] / oh,
                       orig[..., 0] / ow, orig[..., 2] / ow], -1)
    score = F.one_hot((picks.classes.long() - 1).clamp_min(0),
                      num_classes).float() * picks.scores[..., None]
    rows = torch.cat([box, score], -1) * picks.valid[..., None]
    head = torch.zeros((b, 1, 4 + num_classes), device=metas.device)
    head[:, 0, 2:4] = 1.0
    ones = torch.ones((b, 1), dtype=torch.bool, device=metas.device)
    crop = torch.cat([content_box(metas, sizes)[:, None], picks.boxes], 1)
    return Slots(crop, torch.cat([ones, picks.valid], 1),
                 torch.cat([head, rows], 1))


def slot_features(resnet, canvases, slots: Slots, num_slots: int,
                  prec="f32", crop: int = 224) -> torch.Tensor:
    """Crops of the canvases through ResNet-101 -> [B, num_slots, 2048],
    invalid slots zero."""
    b, m = slots.crop_valid.shape
    crops = crop_resize(canvases, slots.crop_boxes, crop, _keys_cubic, prec)
    feats = resnet_features(resnet, normalise(crops.reshape(b * m, crop, crop,
                                                            3)), prec)
    feats = feats.reshape(b, m, -1) * slots.crop_valid[..., None]
    out = torch.zeros((b, num_slots, feats.shape[-1]), device=feats.device)
    out[:, :m] = feats[:, :num_slots]
    return out
