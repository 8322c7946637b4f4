"""Caption serving: a split of region features, or image files.

  * ``decode_split``: the counterpart of the JAX package's
    ``train/loop.py:decode_split``: batches of precomputed object features
    [B, S, 2048] and positions [B, S, 84] go through the encoder (with the
    fused attention kernel), the KV-cached greedy or beam decode and
    ``decode_captions``.
  * ``caption_images``: the counterpart of the JAX package's
    ``serve.py:caption_images``: image files stream through the host
    decode pool and the extraction (``vision/etl.py``: YOLOv5x, or Faster
    R-CNN with ``data.image_model="FasterRCNN"``, then crops and
    ResNet-101 with the fused bottleneck kernel) straight into the same
    decode, without touching disk.

Both decode through ``_decode``, which takes the captioner's own route:
the encoder-decoder's greedy or beam decode, or, for the ``mla_moe``
captioner (``models/lm.py``), its prefill and greedy steps over the latent
cache (``lm_greedy_decode``; greedy only).  ``decode_split`` opens a span
``serve.decode_batch`` a batch.

Both take a ``mesh`` (``parallel.mesh``) and then split each batch over
its data axis, on replicated parameters, as the JAX package does; a model
axis replicates (each data index's rows run once in one process; in a
process group every rank of a model group decodes the same rows), so the
captions are one process's.  The eligibility rule is
``decode_placement``'s.  They keep the CUDA kernels on that path: the JAX
package bypasses its Pallas kernels on the mesh only because a Mosaic call
has no SPMD partitioning rule, and here each device runs its own block
through the same kernels.  The function computed is the same; only the
route differs.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .data.dataset import CocoSplit, ImageBatches
from .data.vocab import decode_captions
from .models.captioner import Captioner
from .models.decoding import (beam_score_mode, beam_search, greedy_decode,
                              lm_greedy_decode)
from .models.lm import LMCaptioner
from .parallel.mesh import Mesh, decode_placement, gather_rows
from .utils.debug import annotate
from .utils.device import DeviceLike, resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _decode(model: Captioner, cfg: Config, feats, poss,
            beam_size: Optional[int], device: DeviceLike) -> torch.Tensor:
    if isinstance(model, LMCaptioner):
        if beam_size is not None and beam_size > 1:
            raise ValueError("the mla_moe captioner decodes greedily; beam "
                             "search over its latent cache is not built")
        return lm_greedy_decode(model, feats, poss, device=device)
    if beam_size is None or beam_size <= 1:
        return greedy_decode(model, feats, poss, device=device)[0]
    return beam_search(model, feats, poss, beam_size=beam_size,
                       score_mode=beam_score_mode(cfg.caption_model),
                       device=device)


def _decode_sharded(models: List[Captioner], place, cfg: Config, feats,
                    poss, beam_size: Optional[int],
                    mesh: Mesh) -> np.ndarray:
    """Each device's rows of a batch through its replica; every process's
    tokens gathered, in row order, as host int64 [B, T]."""
    blocks = [_decode(m, cfg, f, p, beam_size, m.device)
              for m, f, p in zip(models, place(feats), place(poss))]
    return gather_rows(mesh, np.concatenate([b.cpu().numpy()
                                             for b in blocks]))


def decode_split(model: Captioner, cfg: Config, split: CocoSplit,
                 batch_size: int, idx_to_word: Dict[int, str], *,
                 beam_size: Optional[int] = None,
                 device: DeviceLike = None,
                 mesh: Optional[Mesh] = None) -> List[str]:
    """Greedy (``beam_size`` None or 1) or beam decode of every image in a
    split -> caption strings indexed by image row (the
    ``{split}.candidate.captions.pkl`` contract, main.py:172-184).  Beam
    scores follow ``cfg.caption_model``.  Runs on CUDA when ``device`` is
    None; the model must lie on that device.

    With a ``mesh`` whose data axis divides ``batch_size``, each device
    decodes its rows of every batch: in one process through a replica of
    the model per device; over a process group each rank through its
    model, the tokens gathered on every rank (``gather_rows``), so every
    rank returns the same list (callers write on the main one only).  A
    trainer under tensor parallelism passes its full replica
    (``Trainer.decode_model``)."""
    models, place = decode_placement(mesh, model, batch_size)
    out: List[Optional[str]] = [None] * split.num_images
    for feats, poss, idxs, real in ImageBatches(split, batch_size):
        # a batch's span runs from its features on the host to its captions
        with annotate("serve.decode_batch"):
            if place is None:
                tokens = _decode(model, cfg, feats, poss, beam_size,
                                 device).cpu().numpy()
            else:
                tokens = _decode_sharded(models, place, cfg, feats, poss,
                                         beam_size, mesh)
            strs = decode_captions(tokens[:real], idx_to_word)
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
                   compute_dtype=torch.bfloat16,
                   skip_errors: bool = False,
                   on_batch: Optional[Callable[[int, List[Optional[str]]],
                                               None]] = None,
                   progress: Optional[Callable[[int, int], None]] = None,
                   device: DeviceLike = None,
                   mesh: Optional[Mesh] = None) -> List[Optional[str]]:
    """Caption every image, streaming in ``batch_size`` chunks; captions
    come back aligned with ``image_paths``.

    ``beam_size`` None or 1 decodes greedily, above that beam search with
    the score mode of ``cfg.caption_model``.  On the card the extraction
    runs kernel #4 and the encoder kernel #1.  ``compute_dtype`` is
    YOLOv5's extraction's (bfloat16, as in the JAX package); Faster
    R-CNN's runs in float32.  ``skip_errors=True``: an unreadable image
    gets ``None`` instead of failing the run.  ``on_batch(start,
    captions)`` streams each batch out; ``progress(done, n)`` reports.
    Runs on CUDA unless ``device`` says otherwise; the model must lie
    there.

    ``mesh``: a single-process mesh of local devices.  On the YOLOv5 path
    with a ``batch_size`` its data axis divides, extraction
    (``extract_features_sharded``) and decode split each batch over the
    devices, with the extractor and the captioner replicated once per
    device (``parallel.mesh.replicate_cached``); otherwise, and on the
    Faster R-CNN path, one device runs, as in the JAX package."""
    from .vision.etl import stream_extracted_batches
    if mesh is not None and mesh.group is not None:
        raise ValueError("caption_images shards over the local devices of "
                         "one process; run it as a single process")
    if mesh is not None:
        mesh = mesh.over_data          # each data index's rows once
    device = resolve_device(device)
    m = cfg.model
    n = len(image_paths)
    captions: List[Optional[str]] = [None] * n
    models, place = (model, None)
    if cfg.data.image_model != "FasterRCNN":
        models, place = decode_placement(mesh, model, batch_size)
    stream = stream_extracted_batches(
        image_paths, extractor_params=extractor_params,
        weights_dir=weights_dir, num_objects=m.num_objects, max_obj=max_obj,
        batch_size=batch_size, num_workers=num_workers,
        image_model=cfg.data.image_model,
        rect_letterbox=cfg.data.rect_letterbox, feature_mode=feature_mode,
        skip_errors=skip_errors, compute_dtype=compute_dtype, device=device,
        mesh=mesh if place is not None else None)
    batches = iter(stream)
    while True:
        # a batch's span runs from the request for its features (the
        # stream loads and extracts it) to its captions
        with annotate("serve.batch"):
            got = next(batches, None)
            if got is None:
                break
            start, real, failed, feats, poss = got
            # the captioner reads its own position width (84 YOLOv5, 95
            # FRCNN)
            feats, poss = feats.float(), poss[:, :, :m.dim_positions].float()
            if place is None:
                tokens = _decode(model, cfg, feats, poss, beam_size, device)
                with annotate("serve.tokens_to_host"):
                    tokens = tokens.cpu().numpy()
            else:
                tokens = _decode_sharded(models, place, cfg, feats, poss,
                                         beam_size, mesh)
            batch_caps: List[Optional[str]] = decode_captions(
                tokens[:real], idx_to_word)
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
