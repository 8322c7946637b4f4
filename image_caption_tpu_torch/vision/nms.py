"""Fixed-shape class-aware non-maximum suppression, batched over images.

The counterpart of the JAX package's ``vision/nms.py:nms_fixed`` (vmapped
there per image; here one loop over the whole batch):

  1. scores at or below ``conf_thres`` are masked to -1;
  2. the top ``pre_nms`` candidates per image, sorted descending with the
     lowest index first among ties (``jax.lax.top_k``'s rule);
  3. boxes offset by class times the image's coordinate span, so IoU
     across classes is 0; an IoU matrix per image;
  4. ``max_det`` greedy steps: each takes the best available candidate
     (the first maximal index, as ``jnp.argmax``) and masks everything it
     overlaps above ``iou_thres``, itself included;
  5. exactly ``max_det`` boxes per image, zero-padded, with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.decoding import topk_lowest_index


class Detections(NamedTuple):
    boxes: torch.Tensor       # [B, max_det, 4] xyxy (canvas pixels)
    scores: torch.Tensor      # [B, max_det]
    classes: torch.Tensor     # [B, max_det] int32
    valid: torch.Tensor       # [B, max_det] bool


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 4], b [..., M, 4] xyxy -> [..., N, M] IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_fixed(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, *, iou_thres: float = 0.45,
              conf_thres: float = 0.01, max_det: int = 36,
              pre_nms: int = 512) -> Detections:
    """boxes_xyxy [B, N, 4], scores [B, N], classes [B, N] -> Detections
    with leading dim B.  Everything stays on the boxes' device; the loop
    never waits on it."""
    b, n = scores.shape
    k = min(pre_nms, n)
    masked = torch.where(scores > conf_thres, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = topk_lowest_index(masked, k)               # [B, k]
    top_boxes = torch.gather(boxes_xyxy, 1, idx[..., None].expand(b, k, 4))
    top_classes = torch.gather(classes, 1, idx)
    avail = top_scores > conf_thres

    # class-aware: the span of the image's boxes, all N of them
    flat = boxes_xyxy.reshape(b, -1)
    span = flat.amax(dim=1) - flat.amin(dim=1) + 1.0              # [B]
    shifted = top_boxes + (top_classes.float() * span[:, None])[..., None]
    iou = iou_matrix(shifted, shifted)                            # [B, k, k]

    rows = torch.arange(b, device=scores.device)
    lanes = torch.arange(k, device=scores.device)
    picks, oks = [], []
    for _ in range(max_det):
        score_m = torch.where(avail, top_scores,
                              torch.full_like(top_scores, -2.0))
        i = torch.argmax(score_m, dim=1)                          # [B]
        oks.append(score_m[rows, i] > conf_thres)
        avail = avail & ~(iou[rows, i] > iou_thres) & (lanes[None] != i[:, None])
        picks.append(i)
    picks = torch.stack(picks, dim=1)                             # [B, D]
    valid = torch.stack(oks, dim=1)
    boxes = torch.gather(top_boxes, 1, picks[..., None].expand(-1, -1, 4))
    return Detections(
        boxes=torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
        scores=torch.where(valid, torch.gather(top_scores, 1, picks),
                           torch.zeros_like(valid, dtype=top_scores.dtype)),
        classes=torch.where(valid, torch.gather(top_classes, 1, picks),
                            torch.zeros_like(picks)).to(torch.int32),
        valid=valid)
