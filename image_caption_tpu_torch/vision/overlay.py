"""The demo's overlays with PIL: detections and per-word attention.

The counterpart of the JAX package's ``vision/overlay.py``, the reference
demo's per-timestep visualization (``main.py:212-244``): for each decode
step, each detected object box is re-tinted by its cross-attention weight
over a dimmed background, one image written per generated token to
``{out_dir}/{t}_{word}.jpg``.  The detection image and a labels file come
from the reference's save_img paths.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def save_detection_overlay(image_path: str, boxes_xyxy: np.ndarray,
                           scores: np.ndarray, classes: np.ndarray,
                           out_dir: str, *, prefix: str = "det",
                           label_names: Optional[Sequence[str]] = None
                           ) -> str:
    """Annotated detection image + labels txt (the reference's save_img
    paths: detect_for_preprocess.py:80-161, preprocess.py:172-206).
    Returns the image's path."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir, exist_ok=True)
    if label_names is None:
        label_path = os.path.join(os.path.dirname(__file__), "..", "data",
                                  "assets", "coco_labels.txt")
        with open(label_path) as f:
            label_names = f.read().splitlines()

    with Image.open(image_path) as im:
        img = im.convert("RGB")
    draw = ImageDraw.Draw(img)
    lines = []
    for box, score, cls in zip(boxes_xyxy, scores, classes):
        if (box[2] - box[0]) * (box[3] - box[1]) <= 0:
            continue
        x1, y1, x2, y2 = [float(v) for v in box]
        cls = int(cls)
        name = (label_names[cls] if 0 <= cls < len(label_names)
                else str(cls))
        draw.rectangle([x1, y1, x2, y2], outline=(0, 255, 255), width=2)
        draw.text((x1 + 2, max(0.0, y1 - 12)),
                  f"{name} {float(score):.2f}", fill=(255, 255, 255))
        lines.append(f"{name} {x1} {y1} {x2} {y2}")

    name_stem = os.path.splitext(os.path.basename(image_path))[0]
    img_path = os.path.join(out_dir, f"{prefix}_{name_stem}.jpg")
    img.save(img_path)
    with open(os.path.join(out_dir, f"labels_{name_stem}.txt"), "w") as f:
        f.write("\n".join(lines))
    return img_path


def save_attention_overlays(image_path: str, attention: np.ndarray,
                            boxes_xyxy: np.ndarray, caption: str,
                            out_dir: str, *, dim: float = 0.2,
                            max_steps: Optional[int] = None) -> list:
    """attention [T, S] (slot 0 = whole image, 1.. = boxes), boxes [K, 4]
    original-image pixels.  Returns written paths."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    with Image.open(image_path) as im:
        base = np.asarray(im.convert("RGB"), np.float32)

    words = caption.split()
    steps = len(words) if max_steps is None else min(len(words), max_steps)
    steps = min(steps, attention.shape[0])

    valid = (boxes_xyxy[:, 2] - boxes_xyxy[:, 0]) * \
            (boxes_xyxy[:, 3] - boxes_xyxy[:, 1]) > 0
    paths = []
    for t in range(steps):
        att = attention[t]
        # background dimmed; each box brightened by its (normalized) weight
        canvas = base * dim
        obj_att = att[1:1 + len(boxes_xyxy)]
        denom = obj_att.max() if obj_att.size and obj_att.max() > 0 else 1.0
        for k, box in enumerate(boxes_xyxy):
            if not valid[k]:
                continue
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            w = float(obj_att[k]) / denom
            alpha = dim + (1.0 - dim) * w
            canvas[y1:y2, x1:x2] = np.maximum(
                canvas[y1:y2, x1:x2], base[y1:y2, x1:x2] * alpha)
        word = words[t].strip(".") or "end"
        path = os.path.join(out_dir, f"{t}_{word}.jpg")
        Image.fromarray(np.clip(canvas, 0, 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths
