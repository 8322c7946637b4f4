"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference computes from the same inputs.  Every
function returns ``{name: value}``; a cell's limits sit in its
configuration file, and a value above its limit (or not finite) fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def norm_gap(got: Dict[str, float], want: Dict[str, float],
             keys: Sequence[str]) -> float:
    """The worst leaf's gap of norms, against the larger of its own norm
    and the median leaf's."""
    med = float(torch.tensor([want[k] for k in keys]).median())
    return finite(max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
                      for k in keys))


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``/``ref``: ``losses`` of the compared steps, per-leaf norms of
    the first gradient (``grad``) and of the change after the last step
    (``change``).  Leaves whose reference gradient is under a thousandth of
    the median leaf's move under Adam by round-off alone and are left out
    of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    keys = list(ref["grad"])
    med = float(torch.tensor([ref["grad"][k] for k in keys]).median())
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    return {"train.loss_gap": finite(loss),
            "train.grad_gap": norm_gap(prog["grad"], ref["grad"], keys),
            "train.change_gap": norm_gap(prog["change"], ref["change"],
                                         moved)}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].double().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def slots(feats: torch.Tensor, want_feats: torch.Tensor,
          poss: torch.Tensor, want_poss: torch.Tensor) -> float:
    """The worst image's slots: its largest feature difference over its
    largest reference feature [B, S, F], or its largest position-row
    difference (rows of boxes over the image's size and scores, all in
    [0, 1]) [B, S, P], whichever is larger."""
    diff = (feats.float() - want_feats).abs().flatten(1).amax(1)
    scale = want_feats.abs().flatten(1).amax(1).clamp_min(1e-30)
    pos = (poss.float() - want_poss).abs().flatten(1).amax(1)
    return finite(float(torch.maximum(diff / scale, pos).max()))


def detections(boxes: torch.Tensor, scores: torch.Tensor, classes,
               valid: torch.Tensor,
               cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
               cand_classes: torch.Tensor, *, conf: float, iou_thres: float,
               iou_slack: float, pre_nms: int) -> Dict[str, float]:
    """The program's picks of one batch ([B, D] ...) judged against the
    reference's scored candidates ([B, N] ..., before NMS), whatever the
    class: a class is the first of 80 or 90 near-equal logits, and in a
    lower precision than the reference's it flips with rounding.

    * ``det.box``: the pixels (the largest of the four coordinates) between
      each pick and its nearest candidate (a box altered or misplaced; an
      IoU would read thin boxes' rounding as misses);
    * ``det.score``: the gap between a pick's score and the score of that
      nearest candidate;
    * ``det.skipped``: replaying the program's picks in order, the most by
      which a candidate that no earlier pick covers (IoU above
      ``iou_thres - iou_slack``) outscores the pick made instead, or, after
      the last pick when fewer than D were made, outscores the threshold
      (a pick out of order, or one missed).

    Each is given as the worst over the picks and, with ``_median``, as the
    median over them: where the scores are flat (random weights, dozens of
    candidates within a few hundredths) a lower precision than the
    reference's reorders near-equal picks, so that the worst reads the
    landscape and the median reads the computation.
    """
    from .reference.vision import iou
    box, score, skipped = [], [], []
    for i in range(len(boxes)):
        n = int(valid[i].sum())
        pb, ps = boxes[i, :n].float(), scores[i, :n].float()
        if n:
            # every candidate, those scoring near the threshold too
            dist = (pb[:, None] - cand_boxes[i][None]).abs().amax(-1)
            best, at = dist.min(1)
            box.append(best)
            score.append((ps - cand_scores[i][at]).abs())
        # NMS looks at the best ``pre_nms`` candidates above the threshold
        keep = cand_scores[i] > conf
        cb, cs = cand_boxes[i][keep], cand_scores[i][keep]
        top_k = torch.sort(cs, descending=True, stable=True).indices[:pre_nms]
        cb, cs = cb[top_k], cs[top_k]
        alive = torch.ones(len(cb), dtype=torch.bool, device=cb.device)
        supp = iou(pb, cb) > iou_thres - iou_slack if n else None
        for j in range(n + (1 if n < boxes.shape[1] else 0)):
            top = float(cs[alive].max()) if bool(alive.any()) else conf
            made = float(ps[j]) if j < n else conf
            skipped.append(max(top - made, 0.0))
            if j < n:
                alive &= ~supp[j]
    out = {}
    for name, xs in (("det.box", box), ("det.score", score),
                     ("det.skipped", [torch.tensor(skipped)])):
        x = torch.cat([t.flatten().float().cpu() for t in xs]) if xs \
            else torch.zeros(1)
        out[name] = finite(float(x.max()))
        out[name + "_median"] = finite(float(x.median()))
    return out


def token_gap(gaps: torch.Tensor, strings_differ: bool) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best; without bound where a served caption is not the
    reference's detokenisation of its served tokens."""
    if strings_differ:
        return float("inf")
    return finite(float(gaps.max())) if gaps.numel() else 0.0


def strings_differ(got: List[str], want: List[str]) -> bool:
    return len(got) != len(want) or any(a != b for a, b in zip(got, want))
