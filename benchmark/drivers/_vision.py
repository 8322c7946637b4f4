"""What the extraction and captioning drivers share: the extractor's
weights, the pass-through taps that keep what the timed path produced for
the check, the seeded sample of batches, and the check of one batch's
extraction.

Taps: the program's detector entry (``vision.pipeline.yolov5_detect`` or
``frcnn_detect``) and ``serve._decode`` are wrapped, in the window only,
by functions that call them unchanged and keep a reference to their
outputs; nothing is copied or waited for.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from .. import compare
from ..data import images as I
from ..data import weights as W
from ..harness import tf32
from ..reference import vision as RV


class Extractor:
    """The configuration's extractor: the weights (``ref``, a dict the
    reference reads) and the same tensors as the program's parameter
    object (``params``)."""

    def __init__(self, ctx):
        from image_caption_tpu_torch.vision import pipeline as PL
        cfg = ctx.cell.config
        ex = self.ex = cfg["extractor"]
        calib = I.canvases(8, ctx.seed(5), ex["canvas"], ctx.device)[0]
        if ex["detector"] == "YOLOv5":
            self.ref = W.yolo_extractor(cfg, ctx.seed(6), ctx.device, calib)
            self.params = PL.ExtractorParams(yolo=self.ref["yolo"],
                                             resnet=self.ref["resnet"])
        else:
            self.ref = W.frcnn_extractor(cfg, ctx.seed(6), ctx.device, calib)
            self.params = PL.FrcnnExtractorParams(frcnn=self.ref["frcnn"],
                                                  resnet=self.ref["resnet"])
        self.yolo = ex["detector"] == "YOLOv5"
        self.dtype = torch.bfloat16 if ex["precision"] == "bf16" \
            else torch.float32


class Tap:
    """Wrap ``module.name`` so that its last outputs are kept."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.original = getattr(module, name)
        self.last = None

        def wrapper(*args, **kwargs):
            out = self.original(*args, **kwargs)
            self.last = out
            return out
        setattr(module, name, wrapper)

    def remove(self) -> None:
        setattr(self.module, self.name, self.original)


def detector_tap(ex: Extractor) -> Tap:
    from image_caption_tpu_torch.vision import pipeline as PL
    return Tap(PL, "yolov5_detect" if ex.yolo else "frcnn_detect")


class Sample:
    """A uniform sample, drawn from the seed, of ``k`` of the batches the
    window completes (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item


def program_picks(ex: Extractor, det) -> RV.Picks:
    """The program's detections as the reference's picks."""
    if ex.yolo:
        return RV.Picks(det.boxes, det.scores, det.classes, det.valid)
    return RV.Picks(det.boxes, det.scores, det.labels, det.valid)


def candidates(ex: Extractor, canvases, prec: str = "f32"):
    """The reference detector's scored candidates, before NMS."""
    if ex.yolo:
        return RV.yolo_candidates(ex.ref["yolo"], RV.yolo_heads(
            ex.ref["yolo"], canvases.float() / 255.0, prec))
    return RV.frcnn_candidates(ex.ref["frcnn"], canvases, prec,
                               ex.ex["canvas"])


def slots(ex: Extractor, picks: RV.Picks, metas, sizes) -> RV.Slots:
    e = ex.ex
    if ex.yolo:
        return RV.yolo_slots(picks, metas, sizes, e["num_objects"],
                             e["max_obj"], e["num_classes"])
    return RV.frcnn_slots(picks, metas, sizes)


def nms_rule(ex: Extractor) -> Dict:
    return RV.YOLO_NMS if ex.yolo else RV.FRCNN_NMS


def reference_extract(ex: Extractor, canvases, metas, sizes, prec: str,
                      rows: int = 16):
    """The reference in the program's place at ``prec`` ("tf32" or "fp8";
    the control): (picks, features, positions), ``rows`` images at a
    time."""
    p = "f32" if prec == "tf32" else prec
    out = []
    with tf32(prec == "tf32"):
        for s in range(0, len(canvases), rows):
            c = canvases[s:s + rows]
            picks = RV.nms(*candidates(ex, c, p), **nms_rule(ex))
            sl = slots(ex, picks, metas[s:s + rows], sizes[s:s + rows])
            out.append((picks, RV.slot_features(
                ex.ref["resnet"], c, sl, ex.ex["num_objects"] + 1, p,
                ex.ex["crop"]), sl.positions))
    picks = RV.Picks(*(torch.cat(t) for t in zip(*(o[0] for o in out))))
    return (picks, torch.cat([o[1] for o in out]),
            torch.cat([o[2] for o in out]))


def judge(ex: Extractor, canvases, metas, sizes, picks: RV.Picks, feats,
          poss, rows: int = 16) -> Dict[str, float]:
    """One batch's extraction against the float32 reference, ``rows``
    images at a time: the picks against the reference's candidates, the
    position rows and features against the reference's from the same
    picks."""
    rule = nms_rule(ex)
    worst: Dict[str, float] = {}

    def keep(d):
        for k, v in d.items():
            worst[k] = max(worst.get(k, 0.0), v)
    for s in range(0, len(canvases), rows):
        r = slice(s, s + rows)
        c = canvases[r]
        cb, cs, cc = candidates(ex, c)
        pk = RV.Picks(*(t[r] for t in picks))
        keep(compare.detections(*pk, cb, cs, cc, conf=rule["conf"],
                                iou_thres=rule["iou_thres"],
                                iou_slack=ex.ex["iou_slack"],
                                pre_nms=rule["pre_nms"]))
        sl = slots(ex, pk, metas[r], sizes[r])
        want = RV.slot_features(ex.ref["resnet"], c, sl,
                                ex.ex["num_objects"] + 1, "f32",
                                ex.ex["crop"])
        keep({"slot.err": compare.slots(feats[r], want, poss[r],
                                        sl.positions)})
    return worst


def limits(ctx, got: Dict[str, float]) -> Dict[str, tuple]:
    """The numbers the configuration compares, each with its limit."""
    lim = ctx.cell.config["limits"]
    return {k: (v, lim[k]) for k, v in got.items() if k in lim}


def merge(into: Dict[str, float], got: Dict[str, float]) -> None:
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)


def free_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
