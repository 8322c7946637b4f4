"""Host-side image loading: decode and letterbox to uint8 canvases with PIL.

The counterpart of the JAX package's ``vision/loader.py`` PIL path (the
JAX package's native C++ loader is bit-identical to it; its binding waits
for a later slice).  A canvas is the image resized with PIL's bilinear
filter and centred on gray (114), or, for the ultralytics rectangular
letterbox, placed at the top-left with the rect's size in its meta.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .ops import letterbox_params, letterbox_params_rect

FILL = 114


def load_letterboxed(path: str, size: int = 640, rect: bool = False,
                     stride: int = 32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and letterbox one image -> (canvas [S, S, 3] uint8, meta,
    (h, w) float32); meta is [scale, top, left], or [scale, top, left,
    rect_h, rect_w] for the rectangular letterbox."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if rect:
            r, nh, nw, top, left, rect_h, rect_w = letterbox_params_rect(
                h, w, size, stride)
        else:
            r, nh, nw, top, left = letterbox_params(h, w, size)
        resized = im.resize((nw, nh), Image.BILINEAR)
    canvas = np.full((size, size, 3), FILL, np.uint8)
    canvas[top:top + nh, left:left + nw] = np.asarray(resized, np.uint8)
    meta = (np.asarray([r, top, left, rect_h, rect_w], np.float32) if rect
            else np.asarray([r, top, left], np.float32))
    return canvas, meta, np.asarray([h, w], np.float32)


def load_letterboxed_batch(paths: Sequence[str], size: int = 640, *,
                           rect: bool = False, stride: int = 32,
                           io_pool=None, return_ok: bool = False):
    """Decode and letterbox a batch -> (canvases [N, S, S, 3] uint8, metas
    [N, 3|5] f32, sizes [N, 2] f32[, ok [N] bool]), the images mapped over
    ``io_pool`` (an executor) when given.

    ``return_ok=True`` isolates failures: an unreadable image yields a gray
    canvas, an identity meta and ``ok=False``.  Otherwise it raises."""
    meta_dim = 5 if rect else 3

    def blank():
        meta = np.zeros((meta_dim,), np.float32)
        meta[0] = 1.0
        if rect:
            meta[3:] = size
        return (np.full((size, size, 3), FILL, np.uint8), meta,
                np.asarray([size, size], np.float32))

    def load(p):
        try:
            return load_letterboxed(p, size, rect=rect, stride=stride), True
        except Exception:   # any decode failure: PIL raises many kinds
            if not return_ok:
                raise
            return blank(), False

    if not paths:
        out = (np.zeros((0, size, size, 3), np.uint8),
               np.zeros((0, meta_dim), np.float32),
               np.zeros((0, 2), np.float32))
        return out + (np.zeros((0,), bool),) if return_ok else out
    mapper = io_pool.map if io_pool is not None else map
    loaded = list(mapper(load, paths))
    out = (np.stack([c for (c, _, _), _ in loaded]),
           np.stack([m for (_, m, _), _ in loaded]),
           np.stack([z for (_, _, z), _ in loaded]))
    return out + (np.asarray([k for _, k in loaded]),) if return_ok else out
