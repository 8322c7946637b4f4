"""Weights made from the seed on the device, in a few large draws.

Each network's parameter tree comes from its reference's ``spec``: leaves
of one initialiser are cut from one buffer drawn at once by a
``torch.Generator`` on the device, then scaled.  The detectors are then
calibrated as ``chip_smoke.py`` calibrates them (``smoke_extractor``,
``smoke_frcnn_extractor``), with the reference's forward: random weights
as initialised give degenerate detections (every YOLOv5 cell scoring the
same 0.25, no Faster R-CNN box above 0.05) and exploding ResNet
activations, which trained networks do not.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from ..reference import captioner as RC
from ..reference import vision as RV
from ..reference.vision import Leaf


def _leaves(tree, out):
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    return out


def make(tree, seed: int, device):
    """A nested dict/list of ``Leaf`` -> the same structure of float32
    tensors on ``device``: one normal and one uniform draw for all."""
    leaves = _leaves(tree, [])
    count = {k: sum(torch.Size(x.shape).numel() for x in leaves
                    if x.init == k) for k in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(seed)
    bufs = {"normal": torch.randn(count["normal"], generator=gen,
                                  device=device),
            "uniform": torch.rand(count["uniform"], generator=gen,
                                  device=device) * 2 - 1}
    at = {"normal": 0, "uniform": 0}

    def build(t):
        if isinstance(t, Leaf):
            n = int(torch.Size(t.shape).numel())
            if t.init in bufs:
                x = bufs[t.init][at[t.init]:at[t.init] + n].view(t.shape)
                at[t.init] += n
                return x * t.scale
            if t.init == "const":
                return torch.tensor(t.value, dtype=torch.float32,
                                    device=device).view(t.shape)
            return (torch.ones if t.init == "ones" else torch.zeros)(
                t.shape, device=device)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return [build(v) for v in t]
    return build(tree)


def captioner(m: Dict, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """The captioner's state_dict: q/k/v/joint, FFN and classifier weights
    N(0, 2/(in+out)); embedding linears and biases U(+-1/sqrt(in)); the
    word embedding N(0, 1) with the pad row zero; LayerNorm 1 and 0."""
    tree, names = {}, []
    for name, shape, init, fan_in in RC.spec(m):
        if init == "fan_sum":
            leaf = Leaf(shape, "normal", (2.0 / (shape[0] + shape[1])) ** 0.5)
        elif init == "uniform":
            leaf = Leaf(shape, "uniform", fan_in ** -0.5)
        elif init == "embedding":
            leaf = Leaf(shape, "normal", 1.0)
        else:
            leaf = Leaf(shape, init)
        tree[name] = leaf
        names.append(name)
    made = make(tree, seed, device)
    made["decoder.word_embedding.weight"][m["pad_idx"]] = 0.0
    return OrderedDict((n, made[n]) for n in names)


def _small_residuals(resnet) -> None:
    """Each block's last BN scale times 0.2: trained networks keep the
    residual branch small, random ones grow activations to 1e5."""
    for blocks in resnet["layers"]:
        for blk in blocks:
            blk["bn3"]["scale"] = blk["bn3"]["scale"] * 0.2


# Each YOLO conv's output after its folded BN: mean 1 and spread 1 a
# channel.  ``chip_smoke.smoke_extractor`` centres it on 0; a SiLU network
# so calibrated is chaotic (on the card, bf16 against float32: 56-85% of
# the heads' norm apart, and thousands of anchors scoring 1.0), so neither
# its detections nor a check of them mean anything.  Centred on 1 the
# same heads are 0.5-0.8% apart in bf16 and 7-8% in fp8.
YOLO_BN_MEAN = 1.0
# The heads' raw outputs a channel (mean, spread): box offsets as a
# standardised layer gives them; objectness mostly low and class logits
# below zero, so that a few hundred anchors an image score above 0.01 and
# the best near 0.5, as a trained detector's do.
YOLO_HEAD_TARGETS = {"box": (0.0, 1.0), "objectness": (-4.0, 1.5),
                     "class": (-2.0, 1.5)}


@torch.no_grad()
def yolo_extractor(cfg: Dict, seed: int, device, calib) -> Dict:
    """YOLOv5 and ResNet-101 for ``cfg["extractor"]``, calibrated on the
    uint8 canvases ``calib`` [8, S, S, 3]: each YOLO conv's folded BN takes
    its output's mean and spread there (what BatchNorm's running statistics
    hold) to ``YOLO_BN_MEAN`` and 1, and each head conv's channels are set
    to ``YOLO_HEAD_TARGETS``."""
    ex = cfg["extractor"]
    yolo = make(RV.yolo_spec(ex["depth_multiple"], ex["width_multiple"],
                             ex["num_classes"]), seed, device)
    resnet = make(RV.resnet_spec(ex["resnet_stages"]), seed + 1, device)
    _small_residuals(resnet)

    def calibrate(p, y):
        mean = y.mean(dim=(0, 2, 3))
        std = y.std(dim=(0, 2, 3)) + 1e-3
        p["bn"] = {"scale": 1.0 / std, "bias": -mean / std + YOLO_BN_MEAN}
    images = calib.float() / 255.0
    heads = RV.yolo_heads(yolo, images, hook=calibrate)
    for conv, y in zip(yolo["detect"]["convs"], heads):
        y = y.flatten(0, 2)                               # [B*h*w, 3, 5+C]
        mean, std = y.mean(0), y.std(0) + 1e-3
        t_mean, t_std = torch.empty_like(mean), torch.empty_like(std)
        for sl, key in ((slice(0, 4), "box"), (slice(4, 5), "objectness"),
                        (slice(5, None), "class")):
            t_mean[:, sl], t_std[:, sl] = YOLO_HEAD_TARGETS[key]
        k = (t_std / std).flatten()
        conv["kernel"] = conv["kernel"] * k[:, None, None, None]
        conv["bias"] = conv["bias"] * k + (t_mean - mean * t_std / std
                                           ).flatten()
    return {"yolo": yolo, "resnet": resnet}


@torch.no_grad()
def frcnn_extractor(cfg: Dict, seed: int, device, calib) -> Dict:
    """Faster R-CNN and ResNet-101; four heads scaled by their outputs over
    the canvases ``calib``: the RPN's objectness logits to std 1 (as
    initialised they reach the hundreds, and the sigmoid rounds most of them
    to 1.0), the RPN's deltas to std 0.3 and the box head's to std 1
    (deltas of tens clip every box to the canvas), the class logits to std
    2 (else every class scores about 1/91, under the 0.05 threshold)."""
    ex = cfg["extractor"]
    frcnn = make(RV.frcnn_spec(ex["trunk_stages"]), seed, device)
    resnet = make(RV.resnet_spec(ex["resnet_stages"]), seed + 1, device)
    _small_residuals(frcnn["backbone"])
    _small_residuals(resnet)
    canvas = ex["canvas"]

    def scale(head, out, target):
        k = target / float(out.std())
        head["weight"] = head["weight"] * k
        head["bias"] = head["bias"] * k
    maps = RV.fpn_maps(frcnn, RV.normalise(calib))
    rpn = frcnn["rpn"]
    t = [torch.relu(RV._convb(rpn["conv"], fm, "f32")) for fm in maps]
    for head, target in (("cls", 1.0), ("bbox", 0.3)):
        scale(rpn[head], torch.cat([RV._convb(rpn[head], u, "f32").flatten()
                                    for u in t]), target)
    props = RV.rpn_proposals(rpn, maps, canvas)
    x = RV.roi_pool(maps, props)
    h = frcnn["box_head"]
    x = torch.relu(x @ h["fc6"]["weight"].t() + h["fc6"]["bias"])
    x = torch.relu(x @ h["fc7"]["weight"].t() + h["fc7"]["bias"])
    scale(h["cls_score"], x @ h["cls_score"]["weight"].t()
          + h["cls_score"]["bias"], 2.0)
    scale(h["bbox_pred"], x @ h["bbox_pred"]["weight"].t()
          + h["bbox_pred"]["bias"], 1.0)
    return {"frcnn": frcnn, "resnet": resnet}
