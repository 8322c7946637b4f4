"""Operations of the extraction networks, and the bound of kernel #4.

The networks' counts are the reference's convolutions and products run on
``meta`` tensors (shapes only) under ``torch.utils.flop_counter``: one
image through YOLOv5x at its canvas or Faster R-CNN's trunk, FPN, RPN and
box head at its canvas and proposals, one 224-px crop through ResNet-101.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import vision as RV
from . import ELEM_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS


def _meta(tree):
    if isinstance(tree, RV.Leaf):
        return torch.empty(tree.shape, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return [_meta(v) for v in tree]


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def yolo_per_image(depth: float, width: float, classes: int,
                   canvas: int) -> int:
    p = _meta(RV.yolo_spec(depth, width, classes))
    x = torch.empty((1, canvas, canvas, 3), device="meta")
    return _count(lambda: RV.yolo_heads(p, x))


@functools.lru_cache(maxsize=None)
def resnet_per_crop(stages: Sequence[int], crop: int = 224) -> int:
    p = _meta(RV.resnet_spec(stages))
    x = torch.empty((1, 3, crop, crop), device="meta")
    return _count(lambda: RV.resnet_maps(p, x))


@functools.lru_cache(maxsize=None)
def frcnn_per_image(trunk: Sequence[int], canvas: int,
                    proposals: int = 256) -> int:
    """Trunk, FPN, the RPN head on every level and the box head on every
    proposal."""
    p = _meta(RV.frcnn_spec(trunk))
    x = torch.empty((1, 3, canvas, canvas), device="meta")

    def run():
        maps = RV.fpn_maps(p, x)
        for fm in maps:
            t = RV._convb(p["rpn"]["conv"], fm, "f32")
            RV._convb(p["rpn"]["cls"], t, "f32")
            RV._convb(p["rpn"]["bbox"], t, "f32")
        h = p["box_head"]
        r = torch.empty((proposals, RV.FPN * 49), device="meta")
        r = r @ h["fc6"]["weight"].t() @ h["fc7"]["weight"].t()
        r @ h["cls_score"]["weight"].t()
        r @ h["bbox_pred"]["weight"].t()
    return _count(run)


# ResNet-101's identity runs on a 224-px crop: (spatial, channels, width,
# blocks) of stages 1-4, the blocks that kernel #4 runs in one launch each.
IDENTITY_RUNS = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 22),
                 (7, 2048, 512, 2))


def identity_run_bound(run, crops: int, dtype: str) -> float:
    """Least seconds of one identity run over ``crops`` crops: the larger
    of its products at the peak and its bytes (input and output once,
    weights and folded BN once) at the memory's rate."""
    hw, c, wd, n = run
    px = crops * hw * hw
    weights = n * (2 * c * wd + 9 * wd * wd)
    flops = 2 * px * weights
    elem = ELEM_BYTES[dtype]
    nbytes = elem * (2 * px * c + weights) + 4 * n * 2 * (2 * wd + c)
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def kernel4_batch_bound(crops: int, dtype: str) -> float:
    """Least seconds of the four launches of one extraction batch."""
    return sum(identity_run_bound(r, crops, dtype) for r in IDENTITY_RUNS)


def extraction_flops(cfg: Dict, images: int) -> Dict[str, float]:
    """Operations of extracting ``images`` images with ``cfg``'s
    extractor, by the precision the configuration states."""
    ex = cfg["extractor"]
    crops = ex["crops_per_image"]
    res = resnet_per_crop(tuple(ex["resnet_stages"]))
    if ex["detector"] == "YOLOv5":
        det = yolo_per_image(ex["depth_multiple"], ex["width_multiple"],
                             ex["num_classes"], ex["canvas"])
    else:
        det = frcnn_per_image(tuple(ex["trunk_stages"]), ex["canvas"])
    return {ex["precision"]: float(images * (det + crops * res))}
