"""Caption serving on region features: decode every image of a split.

The counterpart of the JAX package's ``train/loop.py:decode_split`` on one
GPU: batches of precomputed object features [B, S, 2048] and positions
[B, S, 84] go through the encoder (with the fused attention kernel), the
KV-cached greedy or beam decode and ``decode_captions``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .config import Config
from .data.dataset import CocoSplit, ImageBatches
from .data.vocab import decode_captions
from .models.captioner import Captioner
from .models.decoding import beam_score_mode, beam_search, greedy_decode
from .utils.device import DeviceLike


def decode_split(model: Captioner, cfg: Config, split: CocoSplit,
                 batch_size: int, idx_to_word: Dict[int, str], *,
                 beam_size: Optional[int] = None,
                 device: DeviceLike = None) -> List[str]:
    """Greedy (``beam_size`` None or 1) or beam decode of every image in a
    split -> caption strings indexed by image row (the
    ``{split}.candidate.captions.pkl`` contract, main.py:172-184).  Beam
    scores follow ``cfg.caption_model``.  Runs on CUDA when ``device`` is
    None; the model must lie on that device."""
    out: List[Optional[str]] = [None] * split.num_images
    for feats, poss, idxs, real in ImageBatches(split, batch_size):
        if beam_size is None or beam_size <= 1:
            tokens, _ = greedy_decode(model, feats, poss, use_kernel=True,
                                      device=device)
        else:
            tokens = beam_search(model, feats, poss, beam_size=beam_size,
                                 score_mode=beam_score_mode(
                                     cfg.caption_model),
                                 use_kernel=True, device=device)
        strs = decode_captions(tokens[:real].cpu().numpy(), idx_to_word)
        for i, s in zip(idxs[:real], strs):
            out[int(i)] = s
    return [s if s is not None else "" for s in out]
