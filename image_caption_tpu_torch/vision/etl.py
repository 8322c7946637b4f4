"""The host-to-device extraction stream that serving runs on.

The counterpart of the JAX package's ``vision/etl.py:stream_extracted_batches``
on one GPU: host threads decode and letterbox batch k+1 while the device
extracts batch k; the last, ragged batch is padded to the batch size with
copies of its first image so every call sees one shape.  The rest of the
JAX module (the offline COCO ETL, shards, caption processing) and its
Faster R-CNN, ``roi`` and multi-device options come with later slices.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .loader import load_letterboxed_batch
from .pipeline import (ExtractorParams, extract_features_batch,
                       load_extractor, validate_feature_mode)

CANVAS = 640


def stream_extracted_batches(
        image_paths: Sequence[str], *,
        extractor_params: Optional[ExtractorParams] = None,
        weights_dir: Optional[str] = None, num_objects: int = 36,
        max_obj: Optional[int] = None, batch_size: int = 128,
        num_workers: int = 8, image_model: str = "YOLOv5",
        rect_letterbox: bool = False, feature_mode: str = "crop",
        skip_errors: bool = False, use_kernel: bool = True,
        compute_dtype=torch.bfloat16, device: DeviceLike = None
) -> Iterator[Tuple[int, int, List[int], torch.Tensor, torch.Tensor]]:
    """Yield ``(start, real, failed, feats, poss)`` per ``batch_size``
    chunk of ``image_paths``: ``real`` rows of the padded batch are images,
    ``failed`` lists the batch-relative rows that could not be read (only
    with ``skip_errors``; they hold a gray canvas), and ``feats``
    [B, S, 2048] / ``poss`` [B, S, 84] stay on ``device`` (the card unless
    told otherwise) without a wait.  Extractor weights load from
    ``weights_dir`` (random when absent) unless ``extractor_params`` are
    given."""
    validate_feature_mode(feature_mode, image_model)
    device = resolve_device(device)
    if extractor_params is None:
        extractor_params = load_extractor(weights_dir, device=device)

    # two pools: decodes fan out on io_pool while batch_pool's one thread
    # runs load_batch itself (one pool would deadlock at num_workers=1)
    io_pool = ThreadPoolExecutor(max(1, num_workers))
    batch_pool = ThreadPoolExecutor(1)

    def load_batch(start):
        paths = image_paths[start:start + batch_size]
        failed: List[int] = []
        if skip_errors:
            canvases, metas, sizes, ok = load_letterboxed_batch(
                paths, CANVAS, rect=rect_letterbox, io_pool=io_pool,
                return_ok=True)
            failed = np.nonzero(~ok)[0].tolist()
        else:
            canvases, metas, sizes = load_letterboxed_batch(
                paths, CANVAS, rect=rect_letterbox, io_pool=io_pool)
        real = len(paths)
        if real < batch_size:                    # pad to the static shape
            reps = batch_size - real
            canvases = np.concatenate([canvases,
                                       np.repeat(canvases[:1], reps, 0)])
            metas = np.concatenate([metas, np.repeat(metas[:1], reps, 0)])
            sizes = np.concatenate([sizes, np.repeat(sizes[:1], reps, 0)])
        return canvases, metas, sizes, real, failed

    starts = list(range(0, len(image_paths), batch_size))
    try:
        pending = batch_pool.submit(load_batch, starts[0]) if starts else None
        for i, start in enumerate(starts):
            canvases, metas, sizes, real, failed = pending.result()
            if i + 1 < len(starts):
                pending = batch_pool.submit(load_batch, starts[i + 1])
            feats, poss, _ = extract_features_batch(
                extractor_params, torch.from_numpy(canvases),
                torch.from_numpy(metas), torch.from_numpy(sizes),
                num_objects=num_objects, max_obj=max_obj,
                compute_dtype=compute_dtype, use_kernel=use_kernel,
                device=device)
            yield start, real, failed, feats, poss
    finally:
        batch_pool.shutdown()
        io_pool.shutdown()
