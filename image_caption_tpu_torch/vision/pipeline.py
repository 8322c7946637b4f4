"""Region-feature extraction: detector -> crops -> ResNet -> slots.

The counterpart of the JAX package's ``vision/pipeline.py`` (crop mode):

  letterboxed canvases [B, 640, 640, 3] -> YOLOv5 detection with
  fixed-shape NMS -> the reference's slot selection (``cap_half``: keep
  num_objects // 2 detections; ``max_obj``: the largest-area boxes,
  compacted) -> crop-and-resize of the whole content region and every
  selected box to 224 -> one ResNet-101 forward over [B * (1 + M), 224,
  224, 3] -> zero-padded feature and position slots.

Position rows are [x1/W, y1/H, x2/W, y2/H] + the score one-hot at the class
index; the whole-image row is [0, 0, 1, 1] + zeros; with ``max_obj`` only
the whole-image row and the largest detection's row survive.

Everything runs on one device, the card unless ``device`` says otherwise;
the parameters must lie there.  ``use_kernel=True`` sends ResNet's
identity runs through the fused bottleneck kernel (kernel #4).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.decoding import topk_lowest_index
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map
from .nms import Detections
from .ops import crop_and_resize, unletterbox_boxes
from .resnet import (IMAGENET_MEAN, IMAGENET_STD, init_resnet,
                     load_torch_checkpoint, resnet_features)
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


def validate_feature_mode(mode: str, image_model: str = "YOLOv5") -> None:
    """Unknown modes raise ``ValueError``; ``roi`` and Faster R-CNN raise
    ``NotImplementedError``: the port extracts per-crop YOLOv5 features
    only so far."""
    if mode not in FEATURE_MODES:
        raise ValueError(f"unknown feature_mode {mode!r}; expected one of "
                         f"{FEATURE_MODES}")
    if image_model not in ("YOLOv5", "FasterRCNN"):
        raise ValueError(f"unknown image_model {image_model!r}")
    if image_model == "FasterRCNN":
        raise NotImplementedError(
            f"the Faster R-CNN extractor is not ported yet: {_LATER}")
    if mode == "roi":
        raise NotImplementedError(
            f"feature_mode='roi' (shared-trunk extraction) is not ported "
            f"yet: {_LATER}")


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
                       compute_dtype) -> _Selected:
    """YOLO detection and the reference's slot-selection quirks."""
    k = num_objects
    rect_hw = metas[:, 3:5] if metas.shape[1] >= 5 else None
    det = yolov5_detect(params.yolo, canvases / 255.0, max_det=k,
                        num_classes=num_classes,
                        focus_stem=stem_is_focus(params.yolo),
                        compute_dtype=compute_dtype, rect_hw=rect_hw)
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
    device = resolve_device(device)
    if params.device.type != device.type:
        raise ValueError(f"the extractor's parameters lie on "
                         f"{params.device}, the call asked for {device}")
    canvases = torch.as_tensor(canvases, device=device).float()
    metas = torch.as_tensor(metas, device=device).float()
    orig_sizes = torch.as_tensor(orig_sizes, device=device).float()
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
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    crops = (crops.float() / 255.0 - mean) / std
    flat = crops.reshape(b * m, crop_size, crop_size, 3)
    feats_sel = resnet_features(params.resnet, flat,
                                compute_dtype=compute_dtype,
                                use_kernel=use_kernel).reshape(b, m, -1)
    return _assemble_outputs(sel, feats_sel, num_objects=num_objects,
                             max_obj=max_obj, num_classes=num_classes)
