"""Caption serving: a split of region features, or image files.

  * ``decode_split``: the counterpart of the JAX package's
    ``train/loop.py:decode_split`` on one GPU: batches of precomputed
    object features [B, S, 2048] and positions [B, S, 84] go through the
    encoder (with the fused attention kernel), the KV-cached greedy or beam
    decode and ``decode_captions``.
  * ``caption_images``: the counterpart of the JAX package's
    ``serve.py:caption_images`` on one GPU: image files stream through the
    host decode pool and the extraction (``vision/etl.py``: YOLOv5x, or
    Faster R-CNN with ``data.image_model="FasterRCNN"``, then crops and
    ResNet-101 with the fused bottleneck kernel) straight into the same
    decode, without touching disk.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from .config import Config
from .data.dataset import CocoSplit, ImageBatches
from .data.vocab import decode_captions
from .models.captioner import Captioner
from .models.decoding import beam_score_mode, beam_search, greedy_decode
from .utils.device import DeviceLike, resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _decode(model: Captioner, cfg: Config, feats, poss,
            beam_size: Optional[int], use_kernel: bool,
            device: DeviceLike) -> torch.Tensor:
    if beam_size is None or beam_size <= 1:
        return greedy_decode(model, feats, poss, use_kernel=use_kernel,
                             device=device)[0]
    return beam_search(model, feats, poss, beam_size=beam_size,
                       score_mode=beam_score_mode(cfg.caption_model),
                       use_kernel=use_kernel, device=device)


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
        tokens = _decode(model, cfg, feats, poss, beam_size, True, device)
        strs = decode_captions(tokens[:real].cpu().numpy(), idx_to_word)
        for i, s in zip(idxs[:real], strs):
            out[int(i)] = s
    return [s if s is not None else "" for s in out]


def list_images(image_dir: str) -> List[str]:
    """The images of a directory, sorted (the output order), regular files
    only, not recursive."""
    return sorted(
        p for f in os.listdir(image_dir)
        if f.lower().endswith(IMAGE_EXTS)
        and os.path.isfile(p := os.path.join(image_dir, f)))


def caption_images(cfg: Config, image_paths: Sequence[str],
                   model: Captioner, idx_to_word: Dict[int, str], *,
                   extractor_params=None,
                   weights_dir: Optional[str] = None,
                   beam_size: Optional[int] = None, batch_size: int = 32,
                   max_obj: Optional[int] = None,
                   feature_mode: str = "crop", num_workers: int = 8,
                   use_kernel: bool = True, compute_dtype=torch.bfloat16,
                   skip_errors: bool = False,
                   on_batch: Optional[Callable[[int, List[Optional[str]]],
                                               None]] = None,
                   progress: Optional[Callable[[int, int], None]] = None,
                   device: DeviceLike = None) -> List[Optional[str]]:
    """Caption every image, streaming in ``batch_size`` chunks; captions
    come back aligned with ``image_paths``.

    ``beam_size`` None or 1 decodes greedily, above that beam search with
    the score mode of ``cfg.caption_model``.  ``use_kernel`` sends both the
    extraction (kernel #4) and the encoder (kernel #1) through the CUDA
    kernels on the card.  ``compute_dtype`` is YOLOv5's extraction's
    (bfloat16, as in the JAX package); Faster R-CNN's runs in float32.
    ``skip_errors=True``: an unreadable image gets ``None`` instead of
    failing the run.  ``on_batch(start, captions)``
    streams each batch out; ``progress(done, n)`` reports.  Runs on CUDA
    unless ``device`` says otherwise; the model must lie there."""
    from .vision.etl import stream_extracted_batches
    device = resolve_device(device)
    m = cfg.model
    n = len(image_paths)
    captions: List[Optional[str]] = [None] * n
    stream = stream_extracted_batches(
        image_paths, extractor_params=extractor_params,
        weights_dir=weights_dir, num_objects=m.num_objects, max_obj=max_obj,
        batch_size=batch_size, num_workers=num_workers,
        image_model=cfg.data.image_model,
        rect_letterbox=cfg.data.rect_letterbox, feature_mode=feature_mode,
        skip_errors=skip_errors, use_kernel=use_kernel,
        compute_dtype=compute_dtype, device=device)
    for start, real, failed, feats, poss in stream:
        # the captioner reads its own position width (84 YOLOv5, 95 FRCNN)
        tokens = _decode(model, cfg, feats.float(),
                         poss[:, :, :m.dim_positions].float(), beam_size,
                         use_kernel, device)
        batch_caps: List[Optional[str]] = decode_captions(
            tokens[:real].cpu().numpy(), idx_to_word)
        for j in failed:
            batch_caps[j] = None
        captions[start:start + real] = batch_caps
        if on_batch is not None:
            on_batch(start, batch_caps)
        if progress is not None:
            progress(start + real, n)
    return captions


def caption_images_to_jsonl(paths: Sequence[str],
                            captions: Sequence[Optional[str]]
                            ) -> Iterator[str]:
    """One JSON object per image in input order; a ``None`` caption (an
    image skipped as unreadable) becomes an ``error`` record."""
    for p, c in zip(paths, captions):
        if c is None:
            yield json.dumps({"image": p, "error": "unreadable image"})
        else:
            yield json.dumps({"image": p, "caption": c})
