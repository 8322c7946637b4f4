"""Region-feature extraction: detector -> crops (or a shared trunk) ->
ResNet -> slots.

The counterpart of the JAX package's ``vision/pipeline.py`` for YOLOv5:

  letterboxed canvases [B, 640, 640, 3] -> YOLOv5 detection with
  fixed-shape NMS -> the reference's slot selection (``cap_half``: keep
  num_objects // 2 detections; ``max_obj``: the largest-area boxes,
  compacted) -> crop-and-resize of the whole content region and every
  selected box to 224 -> one ResNet-101 forward over [B * (1 + M), 224,
  224, 3] -> zero-padded feature and position slots.

``extract_features_roi`` (``feature_mode="roi"``) keeps detection and
selection but encodes each canvas once: ResNet-101's stride-32 map at
``trunk_size`` is ROI-pooled for every slot box.

Position rows are [x1/W, y1/H, x2/W, y2/H] + the score one-hot at the class
index; the whole-image row is [0, 0, 1, 1] + zeros; with ``max_obj`` only
the whole-image row and the largest detection's row survive.

Everything runs on one device, the card unless ``device`` says otherwise;
the parameters must lie there.  ``use_kernel=True`` sends ResNet's
identity runs through the fused bottleneck kernel (kernel #4).  The
Faster R-CNN extractor is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.decoding import topk_lowest_index
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map
from .nms import Detections
from .ops import crop_and_resize, letterbox_image, resize, unletterbox_boxes
from .resnet import (IMAGENET_MEAN, IMAGENET_STD, init_resnet,
                     load_torch_checkpoint, resnet_feature_maps,
                     resnet_features)
from .yolov5 import init_yolov5, load_checkpoint, stem_is_focus, yolov5_detect

FEATURE_MODES = ("crop", "roi")
_LATER = "it comes with a later slice of the port (ROADMAP)"


class ExtractorParams(NamedTuple):
    yolo: Dict
    resnet: Dict

    def to(self, device) -> "ExtractorParams":
        return tree_map(lambda t: t.to(device), self)

    @property
    def device(self) -> torch.device:
        return self.resnet["stem"]["conv"].device


def init_extractor(seed: int = 0, *,
                   device: DeviceLike = None) -> ExtractorParams:
    """Random YOLOv5x + ResNet-101 parameters from ``seed`` on ``device``
    (the card unless told otherwise)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return ExtractorParams(yolo=init_yolov5(gen),
                           resnet=init_resnet(gen)).to(device)


def load_extractor(weights_dir: Optional[str], *,
                   device: DeviceLike = None) -> ExtractorParams:
    """YOLOv5x + ResNet-101 weights from ``weights_dir`` (``yolov5x.npz``
    or ``.pt``, ``resnet101.npz`` or ``.pth``) on ``device``; random
    weights from seed 0 when they are absent (a smoke mode)."""
    device = resolve_device(device)
    if weights_dir:
        def find(*names):
            return next((os.path.join(weights_dir, n) for n in names
                         if os.path.exists(os.path.join(weights_dir, n))),
                        None)
        yolo_path = find("yolov5x.npz", "yolov5x.pt")
        resnet_path = find("resnet101.npz", "resnet101.pth")
        if yolo_path and resnet_path:
            return ExtractorParams(
                yolo=load_checkpoint(yolo_path),
                resnet=load_torch_checkpoint(resnet_path)).to(device)
        print(f"[vision] weights not found under {weights_dir!r}; "
              "using random-init backbones (smoke mode)")
    return init_extractor(device=device)


def validate_feature_mode(mode: str, image_model: str = "YOLOv5", *,
                          roi_trunk_size: Optional[int] = None,
                          roi_detect_size: Optional[int] = None) -> None:
    """Fail fast on unknown or unsupported modes: a ``== "roi"`` test
    downstream would otherwise fall back to crop mode on a typo.  Unknown
    modes and models raise ``ValueError``, as does ``roi`` with Faster
    R-CNN, or a roi size that is not a positive multiple of 32 (YOLOv5's
    largest stride: its anchor decode assumes the 8/16/32 grid).  The
    Faster R-CNN extractor raises ``NotImplementedError``."""
    if mode not in FEATURE_MODES:
        raise ValueError(f"unknown feature_mode {mode!r}; expected one of "
                         f"{FEATURE_MODES}")
    if image_model not in ("YOLOv5", "FasterRCNN"):
        raise ValueError(f"unknown image_model {image_model!r}")
    if mode == "roi" and image_model == "FasterRCNN":
        raise ValueError(
            "feature_mode='roi' is only implemented for the YOLOv5 "
            "pipeline; Faster R-CNN pools trunk features through its own "
            "ROI heads")
    if image_model == "FasterRCNN":
        raise NotImplementedError(
            f"the Faster R-CNN extractor is not ported yet: {_LATER}")
    if mode == "roi":
        for name, v in (("roi_trunk_size", roi_trunk_size),
                        ("roi_detect_size", roi_detect_size)):
            if v is not None and (v <= 0 or v % 32):
                raise ValueError(f"{name}={v} must be a positive multiple "
                                 "of 32 (YOLOv5's largest stride)")


def _position_rows(boxes, scores, classes, valid, orig_w, orig_h,
                   num_classes: int) -> torch.Tensor:
    """[B, K, 4] original-pixel xyxy -> [B, K, 4 + num_classes] rows."""
    w, h = orig_w[:, None], orig_h[:, None]
    norm = torch.stack([boxes[..., 0] / w, boxes[..., 1] / h,
                        boxes[..., 2] / w, boxes[..., 3] / h], dim=-1)
    onehot = torch.nn.functional.one_hot(
        classes.long(), num_classes).float() * scores[..., None]
    rows = torch.cat([norm, onehot], dim=-1)
    return rows * valid[..., None]


class _Selected(NamedTuple):
    det: Detections
    valid: torch.Tensor           # [B, K] after cap_half
    boxes_orig: torch.Tensor      # [B, K, 4] original-pixel xyxy
    sel_valid: torch.Tensor       # [B, M] validity of encoded slots 1..M
    sel_boxes: torch.Tensor       # [B, M, 4] canvas-px boxes to encode
    full_box: torch.Tensor        # [B, 4] the whole content rect
    top_idx: Optional[torch.Tensor]   # [B, max_obj] area order
    ow: torch.Tensor
    oh: torch.Tensor


def _detect_and_select(params: ExtractorParams, canvases, metas, orig_sizes,
                       *, num_objects: int, cap_half: bool,
                       max_obj: Optional[int], num_classes: int,
                       compute_dtype, det_scale: float = 1.0) -> _Selected:
    """YOLO detection and the reference's slot-selection quirks.
    ``canvases`` may be a resized view of the letterbox canvas (roi mode
    detects at ``detect_size``): ``det_scale`` = view / canvas size; metas
    stay in canvas pixels and the boxes are scaled back to them."""
    k = num_objects
    rect_hw = metas[:, 3:5] * det_scale if metas.shape[1] >= 5 else None
    det = yolov5_detect(params.yolo, canvases / 255.0, max_det=k,
                        num_classes=num_classes,
                        focus_stem=stem_is_focus(params.yolo),
                        compute_dtype=compute_dtype, rect_hw=rect_hw)
    if det_scale != 1.0:
        det = det._replace(boxes=det.boxes / det_scale)
    valid = det.valid
    if cap_half:
        # the reference keeps num_obj // 2 detections
        keep = torch.arange(k, device=valid.device)[None] < num_objects // 2
        valid = valid & keep
    oh, ow = orig_sizes[:, 0].float(), orig_sizes[:, 1].float()
    boxes_orig = unletterbox_boxes(det.boxes, metas, oh, ow)

    if max_obj is not None:
        # the max_obj largest-area boxes, area-descending, compacted into
        # slots 1..max_obj
        area = ((boxes_orig[..., 2] - boxes_orig[..., 0])
                * (boxes_orig[..., 3] - boxes_orig[..., 1]))
        area = torch.where(valid, area, torch.full_like(area, -1.0))
        _, top_idx = topk_lowest_index(area, max_obj)            # [B, M]
        sel_valid = torch.gather(valid, 1, top_idx)
        sel_boxes = torch.gather(det.boxes, 1,
                                 top_idx[..., None].expand(-1, -1, 4))
    else:
        n_det = num_objects // 2 if cap_half else num_objects
        top_idx = None
        sel_valid = valid[:, :n_det]
        sel_boxes = det.boxes[:, :n_det]

    r, top, left = metas[:, 0], metas[:, 1], metas[:, 2]
    full_box = torch.stack([left, top, left + ow * r, top + oh * r], dim=-1)
    return _Selected(det=det, valid=valid, boxes_orig=boxes_orig,
                     sel_valid=sel_valid, sel_boxes=sel_boxes,
                     full_box=full_box, top_idx=top_idx, ow=ow, oh=oh)


def _assemble_outputs(sel: _Selected, feats_sel: torch.Tensor, *,
                      num_objects: int, max_obj: Optional[int],
                      num_classes: int):
    """Zero-pad encoded features to S = num_objects + 1 slots and build the
    position rows."""
    b, m1, d = feats_sel.shape
    s = num_objects + 1
    dev = feats_sel.device
    slot_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                            sel.sel_valid], dim=1)
    feats = torch.zeros((b, s, d), dtype=feats_sel.dtype, device=dev)
    feats[:, :m1] = (feats_sel * slot_valid[..., None])[:, :s]

    pos_obj = _position_rows(sel.boxes_orig, sel.det.scores, sel.det.classes,
                             sel.valid, sel.ow, sel.oh, num_classes)
    full_row = torch.zeros((b, 1, 4 + num_classes), device=dev)
    full_row[:, :, 2:4] = 1.0
    if max_obj is not None:
        # exactly two rows survive: the whole image's and the largest
        # detection's (the cached-dataset configuration)
        row1 = torch.gather(pos_obj, 1, sel.top_idx[:, :1, None].expand(
            -1, -1, pos_obj.shape[-1]))
        row1 = row1 * sel.sel_valid[:, :1, None]
        positions = torch.cat(
            [full_row, row1,
             torch.zeros((b, s - 2, 4 + num_classes), device=dev)], dim=1)
    else:
        positions = torch.cat([full_row, pos_obj], dim=1)
    return feats, positions[:, :s], sel.boxes_orig


def _on_device(params: ExtractorParams, device: DeviceLike, *arrays):
    """The float32 inputs on ``device`` (the card unless told otherwise),
    where the extractor's parameters must lie."""
    device = resolve_device(device)
    if params.device.type != device.type:
        raise ValueError(f"the extractor's parameters lie on "
                         f"{params.device}, the call asked for {device}")
    return [torch.as_tensor(a, device=device).float() for a in arrays]


@torch.no_grad()
def extract_features_batch(params: ExtractorParams, canvases, metas,
                           orig_sizes, *, num_objects: int = 36,
                           cap_half: bool = True,
                           max_obj: Optional[int] = None,
                           num_classes: int = 80, crop_size: int = 224,
                           compute_dtype=torch.bfloat16,
                           use_kernel: bool = True,
                           device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The per-crop pipeline for a batch.

    canvases   [B, S, S, 3] RGB 0..255 (uint8 or float), letterboxed;
    metas      [B, 3] (scale, top, left), or [B, 5] with (rect_h, rect_w)
               of a rectangular letterbox, whose cells beyond the rect the
               detector masks;
    orig_sizes [B, 2] (h, w) original pixels.
    Returns (features [B, S', 2048] f32, positions [B, S', 4 + C] f32,
    boxes [B, K, 4] original-pixel xyxy) with S' = num_objects + 1, on
    ``device``.  ``compute_dtype`` defaults to bfloat16 as in the JAX
    package; float32 is for parity studies."""
    canvases, metas, orig_sizes = _on_device(params, device, canvases,
                                             metas, orig_sizes)
    b = canvases.shape[0]
    sel = _detect_and_select(params, canvases, metas, orig_sizes,
                             num_objects=num_objects, cap_half=cap_half,
                             max_obj=max_obj, num_classes=num_classes,
                             compute_dtype=compute_dtype)

    # slot 0 = the whole letterboxed content region
    crop_boxes = torch.cat([sel.full_box[:, None], sel.sel_boxes], dim=1)
    m = crop_boxes.shape[1]
    # the resample runs in the compute dtype (two dense matmuls per crop)
    crops = crop_and_resize(canvases.to(compute_dtype), crop_boxes,
                            crop_size)                     # [B, M, S, S, 3]
    mean = torch.from_numpy(IMAGENET_MEAN).to(crops.device)
    std = torch.from_numpy(IMAGENET_STD).to(crops.device)
    crops = (crops.float() / 255.0 - mean) / std
    flat = crops.reshape(b * m, crop_size, crop_size, 3)
    feats_sel = resnet_features(params.resnet, flat,
                                compute_dtype=compute_dtype,
                                use_kernel=use_kernel).reshape(b, m, -1)
    return _assemble_outputs(sel, feats_sel, num_objects=num_objects,
                             max_obj=max_obj, num_classes=num_classes)


@torch.no_grad()
def extract_features_roi(params: ExtractorParams, canvases, metas,
                         orig_sizes, *, num_objects: int = 36,
                         cap_half: bool = True,
                         max_obj: Optional[int] = None,
                         num_classes: int = 80, trunk_size: int = 448,
                         roi_bins: int = 7,
                         detect_size: Optional[int] = None,
                         compute_dtype=torch.bfloat16,
                         device: DeviceLike = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Shared-trunk extraction (``feature_mode="roi"``): the same inputs,
    outputs, detection and slot selection as ``extract_features_batch``,
    but each canvas is encoded once, by ResNet-101 through stage 4 at
    ``trunk_size``, and every slot's feature is the mean of a
    ``roi_bins`` x ``roi_bins`` bilinear ROI crop of that stride-32 map.

    ``detect_size`` runs YOLOv5 on a resized view of the canvas (None: the
    canvas itself, and then detection and selection equal crop mode's bit
    for bit).  Resized views are antialiased bilinear in the compute
    dtype, as ``jax.image.resize`` computes them in the JAX package.  The
    features are pooled trunk activations, not per-crop encodings: a
    captioner decodes with the feature mode it was trained on."""
    canvases, metas, orig_sizes = _on_device(params, device, canvases,
                                             metas, orig_sizes)
    canvas_size = canvases.shape[1]
    detect_size = detect_size or canvas_size
    validate_feature_mode("roi", roi_trunk_size=trunk_size,
                          roi_detect_size=detect_size)

    def view(size):
        if size == canvas_size:
            # the float32 canvas itself: a compute-dtype copy would round
            # the detector's input and could flip a score tie against
            # crop mode
            return canvases
        return resize(canvases.to(compute_dtype), size, size)

    det_canvas = view(detect_size)
    sel = _detect_and_select(params, det_canvas, metas, orig_sizes,
                             num_objects=num_objects, cap_half=cap_half,
                             max_obj=max_obj, num_classes=num_classes,
                             compute_dtype=compute_dtype,
                             det_scale=detect_size / canvas_size)

    x = det_canvas if trunk_size == detect_size else view(trunk_size)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    x = ((x.float() / 255.0 - mean) / std).to(compute_dtype)
    c5 = resnet_feature_maps(params.resnet, x,
                             compute_dtype=compute_dtype)[-1].float()

    # slot 0 = the whole content rect; canvas px -> stride-32 map cells
    roi_boxes = torch.cat([sel.full_box[:, None], sel.sel_boxes], dim=1)
    fm_scale = (trunk_size / canvas_size) / 32.0
    rois = crop_and_resize(c5.contiguous(), roi_boxes * fm_scale, roi_bins,
                           method="linear")          # [B, 1+M, r, r, C]
    feats_sel = rois.mean(dim=(2, 3))
    return _assemble_outputs(sel, feats_sel, num_objects=num_objects,
                             max_obj=max_obj, num_classes=num_classes)


# ---------------------------------------------------------------------------
# One image from a file (the demo)
# ---------------------------------------------------------------------------

def load_image_rgb(path: str) -> np.ndarray:
    """An image file -> [H, W, 3] uint8 RGB."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), np.uint8)


_EXTRACTORS: Dict[Tuple[Optional[str], str], ExtractorParams] = {}


def extract_single_image(path: str, *, image_model: str = "YOLOv5",
                         num_objects: int = 36,
                         max_obj: Optional[int] = None,
                         weights_dir: Optional[str] = None,
                         rect: bool = False, compute_dtype=torch.bfloat16,
                         device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One image file -> (features [S, 2048], positions [S, 84], boxes
    [K, 4] original-pixel xyxy) as numpy arrays, extracted on ``device``
    (the card unless told otherwise; ResNet through kernel #4 there): the
    JAX package's ``extract_single_image`` for YOLOv5.  The square letterbox resizes the
    decoded image on the device (``letterbox_image``); ``rect`` takes the
    loader's rectangular letterbox.  The extractor is loaded once per
    (``weights_dir``, device)."""
    if image_model not in ("YOLOv5", "FasterRCNN"):
        raise ValueError(f"unknown image_model {image_model!r}")
    if image_model == "FasterRCNN":
        raise NotImplementedError(
            f"the Faster R-CNN extractor is not ported yet: {_LATER}")
    device = resolve_device(device)
    key = (weights_dir, str(device))
    if key not in _EXTRACTORS:
        _EXTRACTORS[key] = load_extractor(weights_dir, device=device)
    if rect:
        from .loader import load_letterboxed
        canvas, meta, hw = load_letterboxed(path, 640, rect=True)
        canvas = torch.from_numpy(canvas)
        meta = torch.from_numpy(meta)
    else:
        img = torch.from_numpy(load_image_rgb(path)).to(device)
        hw = np.asarray(img.shape[:2], np.float32)
        canvas, meta = letterbox_image(img, 640)
    feats, poss, boxes = extract_features_batch(
        _EXTRACTORS[key], canvas[None], meta[None], hw[None],
        num_objects=num_objects, max_obj=max_obj,
        compute_dtype=compute_dtype, device=device)
    return (feats[0].cpu().numpy(), poss[0].cpu().numpy(),
            boxes[0].cpu().numpy())
