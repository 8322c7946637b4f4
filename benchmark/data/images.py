"""Seeded images: letterboxed canvases and JPEG files.

Copies of ``chip_smoke.letterboxed_canvases`` (images of 300-640 px a side
whose pixels are uniform noise, letterboxed on gray 114) and
``chip_smoke.write_jpegs`` (smooth random colour fields, 300-640 px a side,
quality 90).  Sizes come from ``numpy.random.RandomState``; the canvases'
pixels are drawn on the device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from ..reference.vision import letterbox_geometry


def canvases(n: int, seed: int, size: int, device
             ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(uint8 canvases [n, size, size, 3] on ``device``, metas [n, 3]
    (scale, top, left), original sizes [n, 2] (h, w))."""
    rng = np.random.RandomState(seed % 2 ** 32)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.full((n, size, size, 3), 114, dtype=torch.uint8,
                     device=device)
    metas, sizes = [], []
    for i in range(n):
        h, w = rng.randint(300, 641, size=2)
        r, nh, nw, top, left = letterbox_geometry(h, w, size)
        out[i, top:top + nh, left:left + nw] = torch.randint(
            0, 256, (nh, nw, 3), generator=gen, device=device,
            dtype=torch.uint8)
        metas.append([r, top, left])
        sizes.append([h, w])
    return out, np.asarray(metas, np.float32), np.asarray(sizes, np.float32)


def _jpeg(args):
    from PIL import Image
    path, h, w, small = args
    Image.fromarray(small).resize((w, h), Image.BILINEAR).save(path,
                                                                quality=90)
    return path


def write_jpegs(directory: str, n: int, seed: int,
                threads: int = 8) -> List[str]:
    """``n`` JPEGs of 300-640 px a side under ``directory``."""
    rng = np.random.RandomState(seed % 2 ** 32)
    jobs = []
    for i in range(n):
        h, w = rng.randint(300, 641, size=2)
        small = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
        jobs.append((os.path.join(directory, f"img{i:04d}.jpg"), h, w, small))
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(_jpeg, jobs))
