"""A seeded caption split in memory: ``chip_smoke.make_split``'s rules,
drawn on the device.

Each image has ``num_objects + 1`` slots of N(0, 1) features and U(0, 1)
positions; image ``i`` keeps slot 0 (the whole image, positions [0, 0, 1,
1] and zeros) and ``n_obj[i]`` objects, 1 <= n_obj <= num_objects - 1, the
rest zero; image 5 is all zero and image 6 a copy of image 0.  Each image
has ``captions`` captions: <START>, words drawn from 4..vocab-1, <END>
after 3 to max_length - 3 words, then pad.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def make_split(m: Dict, n_images: int, captions: int, seed: int, device
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(features [N, S, F] f32, positions [N, S, P] f32, captions
    [N * captions, L] int32, image index of each caption), on the host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s, l_ = m["num_objects"] + 1, m["max_length"]
    feats = torch.randn((n_images, s, m["dim_features"]), generator=gen,
                        device=device)
    pos = torch.rand((n_images, s, m["dim_positions"]), generator=gen,
                     device=device)
    n_obj = torch.randint(1, s - 1, (n_images, 1), generator=gen,
                          device=device)
    keep = torch.arange(s, device=device)[None] <= n_obj
    feats *= keep[..., None]
    pos *= keep[..., None]
    pos[:, 0] = 0.0
    pos[:, 0, 2:4] = 1.0
    feats[5], pos[5] = 0.0, 0.0
    feats[6], pos[6] = feats[0], pos[0]
    n_cap = n_images * captions
    caps = torch.randint(4, m["num_vocab"], (n_cap, l_), generator=gen,
                         device=device)
    length = torch.randint(3, l_ - 2, (n_cap, 1), generator=gen, device=device)
    t = torch.arange(l_, device=device)[None]
    caps = torch.where(t == length, 2, torch.where(t > length, 0, caps))
    caps[:, 0] = 1
    image_idxs = np.repeat(np.arange(n_images), captions)
    return (feats.cpu().numpy(), pos.cpu().numpy(),
            caps.to(torch.int32).cpu().numpy(), image_idxs)
