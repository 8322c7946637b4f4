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

``extract_features_frcnn`` is the Faster R-CNN pipeline
(``data.image_model="FasterRCNN"``): ResNet-50-FPN detection on an
800-px canvas (``vision/frcnn.py``), then the same crops and ResNet-101
in float32, with the reference's rows for that model:
[y1/H, y2/H, x1/W, x2/W] + the 91-wide score one-hot, no halving.

Everything runs on one device, the card unless ``device`` says otherwise;
the parameters must lie there.  ResNet-101's identity runs go through
``fused_stage``: kernel #4 on the card, its plain version on the CPU.
``extract_features_sharded`` splits a batch over the local devices of a
mesh, with a replica of the parameters on each.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.decoding import topk_lowest_index
from ..parallel.mesh import DATA_AXIS, replicate_cached
from ..utils.debug import annotate, count
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map
from .frcnn import NUM_CLASSES as FRCNN_CLASSES
from .frcnn import frcnn_detect, init_frcnn
from .frcnn import load_checkpoint as load_frcnn_checkpoint
from .nms import Detections
from .ops import crop_and_resize, letterbox_image, resize, unletterbox_boxes
from .resnet import (IMAGENET_MEAN, IMAGENET_STD, init_resnet,
                     load_torch_checkpoint, resnet_feature_maps,
                     resnet_features)
from .yolov5 import init_yolov5, load_checkpoint, stem_is_focus, yolov5_detect

FEATURE_MODES = ("crop", "roi")
# the Faster R-CNN path's square letterbox canvas
FRCNN_CANVAS = 800


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


def _find(weights_dir: str, *names: str) -> Optional[str]:
    """The first of ``names`` that exists under ``weights_dir``."""
    return next((os.path.join(weights_dir, n) for n in names
                 if os.path.exists(os.path.join(weights_dir, n))), None)


def load_extractor(weights_dir: Optional[str], *,
                   device: DeviceLike = None) -> ExtractorParams:
    """YOLOv5x + ResNet-101 weights from ``weights_dir`` (``yolov5x.npz``
    or ``.pt``, ``resnet101.npz`` or ``.pth``) on ``device``; random
    weights from seed 0 when they are absent (a smoke mode)."""
    device = resolve_device(device)
    if weights_dir:
        yolo_path = _find(weights_dir, "yolov5x.npz", "yolov5x.pt")
        resnet_path = _find(weights_dir, "resnet101.npz", "resnet101.pth")
        if yolo_path and resnet_path:
            return ExtractorParams(
                yolo=load_checkpoint(yolo_path),
                resnet=load_torch_checkpoint(resnet_path)).to(device)
        print(f"[vision] weights not found under {weights_dir!r}; "
              "using random-init backbones (smoke mode)")
    return init_extractor(device=device)


class FrcnnExtractorParams(NamedTuple):
    frcnn: Dict
    resnet: Dict

    def to(self, device) -> "FrcnnExtractorParams":
        return tree_map(lambda t: t.to(device), self)

    @property
    def device(self) -> torch.device:
        return self.resnet["stem"]["conv"].device


def init_frcnn_extractor(seed: int = 0, *,
                         device: DeviceLike = None) -> FrcnnExtractorParams:
    """Random Faster R-CNN (ResNet-50-FPN) + ResNet-101 parameters from
    ``seed`` on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return FrcnnExtractorParams(frcnn=init_frcnn(gen),
                                resnet=init_resnet(gen)).to(device)


def load_frcnn_extractor(weights_dir: Optional[str], *,
                         device: DeviceLike = None) -> FrcnnExtractorParams:
    """Faster R-CNN + ResNet-101 weights from ``weights_dir``
    (``fasterrcnn_resnet50_fpn.npz`` or ``.pth``, ``resnet101.npz`` or
    ``.pth``) on ``device``; random weights from seed 0 when they are
    absent (a smoke mode)."""
    device = resolve_device(device)
    if weights_dir:
        frcnn_path = _find(weights_dir, "fasterrcnn_resnet50_fpn.npz",
                           "fasterrcnn_resnet50_fpn.pth")
        resnet_path = _find(weights_dir, "resnet101.npz", "resnet101.pth")
        if frcnn_path and resnet_path:
            return FrcnnExtractorParams(
                frcnn=load_frcnn_checkpoint(frcnn_path),
                resnet=load_torch_checkpoint(resnet_path)).to(device)
        print(f"[vision] frcnn weights not found under {weights_dir!r}; "
              "using random-init backbones (smoke mode)")
    return init_frcnn_extractor(device=device)


def validate_feature_mode(mode: str, image_model: str = "YOLOv5", *,
                          roi_trunk_size: Optional[int] = None,
                          roi_detect_size: Optional[int] = None) -> None:
    """Fail fast on unknown or unsupported modes: a ``== "roi"`` test
    downstream would otherwise fall back to crop mode on a typo.  Unknown
    modes and models raise ``ValueError``, as does ``roi`` with Faster
    R-CNN, or a roi size that is not a positive multiple of 32 (YOLOv5's
    largest stride: its anchor decode assumes the 8/16/32 grid)."""
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
    package; float32 is for parity studies.  ``use_kernel`` stays for the
    benchmark's extraction cell and its reference test, which pass
    ``use_kernel=True``; the device picks the ResNet route, so ``False``
    raises."""
    if not use_kernel:
        raise ValueError("extract_features_batch takes use_kernel=True "
                         "only: the device picks the ResNet route, kernel "
                         "#4 on CUDA tensors and its plain version on CPU "
                         "tensors")
    with annotate("extract.batch", device=True):
        canvases, metas, orig_sizes = _on_device(params, device, canvases,
                                                 metas, orig_sizes)
        b = canvases.shape[0]
        with annotate("extract.detect", device=True):
            sel = _detect_and_select(params, canvases, metas, orig_sizes,
                                     num_objects=num_objects,
                                     cap_half=cap_half, max_obj=max_obj,
                                     num_classes=num_classes,
                                     compute_dtype=compute_dtype)

        with annotate("extract.crops", device=True):
            # slot 0 = the whole letterboxed content region
            crop_boxes = torch.cat([sel.full_box[:, None], sel.sel_boxes],
                                   dim=1)
            m = crop_boxes.shape[1]
            # the resample runs in the compute dtype (two dense matmuls per
            # crop)
            crops = crop_and_resize(canvases.to(compute_dtype), crop_boxes,
                                    crop_size)             # [B, M, S, S, 3]
            mean = torch.from_numpy(IMAGENET_MEAN).to(crops.device)
            std = torch.from_numpy(IMAGENET_STD).to(crops.device)
            crops = (crops.float() / 255.0 - mean) / std
            flat = crops.reshape(b * m, crop_size, crop_size, 3)
        with annotate("extract.resnet", device=True):
            feats_sel = resnet_features(params.resnet, flat,
                                        compute_dtype=compute_dtype
                                        ).reshape(b, m, -1)
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


def replicate_extractor_params(mesh, params: ExtractorParams):
    """One copy of the extractor's parameters per device of ``mesh``,
    made once and reused (``parallel.mesh.replicate_cached``): the ETL's
    hot loop calls ``extract_features_sharded`` per batch, and copying the
    YOLOv5x + ResNet-101 weights on every call would dominate it."""
    return replicate_cached(mesh, params)


def extract_features_sharded(mesh, params: ExtractorParams, canvases, metas,
                             orig_sizes, *, feature_mode: str = "crop",
                             **kwargs) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Data-parallel extraction over a single-process ``mesh`` of local
    devices: the batch splits into contiguous row blocks, one per device,
    each extracted by that device's replica of ``params``
    (``extract_features_batch``, with kernel #4 on each, or
    ``extract_features_roi`` by ``feature_mode``), without collectives.
    The batch must divide by the data axis.  Accepts the keyword options
    of those two functions but ``device``; the outputs come back
    concatenated in row order on the mesh's first device."""
    validate_feature_mode(feature_mode,
                          roi_trunk_size=kwargs.get("trunk_size"),
                          roi_detect_size=kwargs.get("detect_size"))
    if mesh.group is not None:
        raise ValueError("extract_features_sharded shards over the local "
                         "devices of one process; run it as a single "
                         "process")
    b = canvases.shape[0]
    ndata = mesh.shape[DATA_AXIS]
    if b % ndata:
        raise ValueError(f"batch {b} not divisible by data axis {ndata}")
    kwargs.pop("device", None)
    fn = extract_features_roi if feature_mode == "roi" \
        else extract_features_batch
    replicas = replicate_extractor_params(mesh, params)
    outs = [fn(p, canvases[rows], metas[rows], orig_sizes[rows], device=d,
               **kwargs)
            for p, d, rows in zip(replicas, mesh.devices,
                                  mesh.row_blocks(b))]
    first = mesh.devices[0]
    return tuple(torch.cat([o[i].to(first, non_blocking=True)
                            for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# Faster R-CNN (core/preprocess.py:141-221 contract)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN convolutions in float32 for the block: PyTorch's default lets
    cuDNN run float32 convs in TF32 (10-bit mantissas), which is not the
    float32 the JAX package computes this path in."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


@torch.no_grad()
def extract_features_frcnn(params: FrcnnExtractorParams, canvases, metas,
                           orig_sizes, *, num_objects: int = 36,
                           canvas: int = FRCNN_CANVAS, crop_size: int = 224,
                           device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The Faster R-CNN pipeline for a batch, in float32 as the JAX package
    computes it (cuDNN's TF32 off for the call; matmuls follow
    ``torch.backends.cuda.matmul.allow_tf32``, off by default).

    canvases   [B, canvas, canvas, 3] RGB 0..255 (uint8 or float), square
               letterbox;
    metas      [B, 3] (scale, top, left); orig_sizes [B, 2] (h, w).
    Returns (features [B, S, 2048], positions [B, S, 95], boxes [B,
    num_objects, 4] original-pixel xyxy) with S = num_objects + 1, on
    ``device``: slot 0 is the letterboxed content region with the row
    [0, 0, 1, 1] + zeros; slots 1.. are the detections by score, NOT
    halved, rows [y1/H, y2/H, x1/W, x2/W] + the score at (label - 1) of 91;
    invalid slots are zero.  ResNet-101's identity runs take kernel #4's
    float32 route on the card."""
    with annotate("extract.batch", device=True):
        canvases, metas, orig_sizes = _on_device(params, device, canvases,
                                                 metas, orig_sizes)
        b = canvases.shape[0]
        mean = torch.from_numpy(IMAGENET_MEAN).to(canvases.device)
        std = torch.from_numpy(IMAGENET_STD).to(canvases.device)
        with _cudnn_f32():
            with annotate("extract.detect", device=True):
                det = frcnn_detect(params.frcnn,
                                   (canvases / 255.0 - mean) / std,
                                   canvas=canvas, max_det=num_objects)
            oh, ow = orig_sizes[:, 0], orig_sizes[:, 1]
            boxes_orig = unletterbox_boxes(det.boxes, metas, oh, ow)

            with annotate("extract.crops", device=True):
                # crops from the canvas; slot 0 = the letterboxed content
                # region
                r, top, left = metas[:, 0], metas[:, 1], metas[:, 2]
                full_box = torch.stack(
                    [left, top, left + ow * r, top + oh * r], dim=-1)
                crops = crop_and_resize(
                    canvases,
                    torch.cat([full_box[:, None], det.boxes], dim=1),
                    crop_size)
                crops = (crops / 255.0 - mean) / std
            with annotate("extract.resnet", device=True):
                feats = resnet_features(
                    params.resnet, crops.reshape(-1, crop_size, crop_size, 3)
                ).reshape(b, num_objects + 1, -1)

        slot_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                           device=canvases.device),
                                det.valid], dim=1)
        count("extract.crops", b * (num_objects + 1))
        count("extract.crops_valid", slot_valid)
        feats = feats * slot_valid[..., None]
        h, w = oh[:, None], ow[:, None]
        norm4 = torch.stack([boxes_orig[..., 1] / h, boxes_orig[..., 3] / h,
                             boxes_orig[..., 0] / w, boxes_orig[..., 2] / w],
                            dim=-1)
        # an invalid slot's label 0 would index -1: its row is zeroed anyway
        onehot = torch.nn.functional.one_hot(
            torch.clamp(det.labels.long() - 1, min=0),
            FRCNN_CLASSES).float() * det.scores[..., None]
        pos_obj = torch.cat([norm4, onehot], dim=-1) * det.valid[..., None]
        full_row = torch.zeros((b, 1, 4 + FRCNN_CLASSES),
                               device=canvases.device)
        full_row[:, :, 2:4] = 1.0
        return feats, torch.cat([full_row, pos_obj], dim=1), boxes_orig


# ---------------------------------------------------------------------------
# One image from a file (the demo)
# ---------------------------------------------------------------------------

def load_image_rgb(path: str) -> np.ndarray:
    """An image file -> [H, W, 3] uint8 RGB."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), np.uint8)


# (weights_dir, device) for YOLOv5, (weights_dir, device, "FasterRCNN")
_EXTRACTORS: Dict[tuple, object] = {}


def extract_single_image(path: str, *, image_model: str = "YOLOv5",
                         num_objects: int = 36,
                         max_obj: Optional[int] = None,
                         weights_dir: Optional[str] = None,
                         rect: bool = False, compute_dtype=torch.bfloat16,
                         device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One image file -> (features [S, 2048], positions [S, P], boxes
    [K, 4] original-pixel xyxy) as numpy arrays, extracted on ``device``
    (the card unless told otherwise; ResNet-101 through kernel #4 there):
    the JAX package's ``extract_single_image``.  YOLOv5 (P = 84): the
    square letterbox resizes the decoded image on the device
    (``letterbox_image``), ``rect`` takes the loader's rectangular
    letterbox.  FasterRCNN (P = 95): the square letterbox at 800 px and
    ``extract_features_frcnn`` in float32; ``max_obj``, ``rect`` and
    ``compute_dtype`` do not apply, as in the JAX package.  The extractor
    is loaded once per (``weights_dir``, device, model)."""
    if image_model not in ("YOLOv5", "FasterRCNN"):
        raise ValueError(f"unknown image_model {image_model!r}")
    device = resolve_device(device)
    if image_model == "FasterRCNN":
        key = (weights_dir, str(device), image_model)
        if key not in _EXTRACTORS:
            _EXTRACTORS[key] = load_frcnn_extractor(weights_dir,
                                                    device=device)
        img = torch.from_numpy(load_image_rgb(path)).to(device)
        hw = np.asarray(img.shape[:2], np.float32)
        canvas, meta = letterbox_image(img, FRCNN_CANVAS)
        feats, poss, boxes = extract_features_frcnn(
            _EXTRACTORS[key], canvas[None], meta[None], hw[None],
            num_objects=num_objects, device=device)
        return (feats[0].cpu().numpy(), poss[0].cpu().numpy(),
                boxes[0].cpu().numpy())
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
