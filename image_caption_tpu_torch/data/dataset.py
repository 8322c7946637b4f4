"""COCO caption split in the reference's on-disk layout, and the decode
batches over its images.

Layout (``core/utils.py:32-64``): ``{data_path}/{split}/{split}.features.hkl``
[N_img, S, 2048], ``{split}.positions.hkl`` [N_img, S, P],
``{split}.file.names.pkl``, ``{split}.captions.pkl`` (int32 [N_cap, L]),
``{split}.image.indices.pkl``, ``{split}.references.pkl``; train also has
``word_index.pkl``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.io import load_hkl, load_pickle, open_hkl

# 'auto' streaming threshold: feature files above this stay on disk and
# batches are read as HDF5 slices
STREAM_THRESHOLD_BYTES = 2 << 30


@dataclass
class CocoSplit:
    """One split: ``features``/``positions`` are numpy arrays or lazily
    sliced ``HklDataset`` views; both support the batch iterators' indexing."""

    features: np.ndarray        # [N_img, S, F] float32 (or HklDataset)
    positions: np.ndarray       # [N_img, S, P] float32 (or HklDataset)
    captions: np.ndarray        # [N_cap, L] int32
    image_idxs: np.ndarray      # [N_cap] int — caption -> image row
    file_names: np.ndarray
    word_to_idx: Optional[Dict[str, int]] = None
    references: Optional[Dict] = None

    @property
    def num_captions(self) -> int:
        return len(self.captions)

    @property
    def num_images(self) -> int:
        return len(self.features)


def load_split(data_path: str, split: str, *, verbose: bool = True,
               load_references: bool = False,
               streaming: str = "auto") -> CocoSplit:
    """load_coco_data equivalent (core/utils.py:32-64).  streaming: 'never'
    reads the features into RAM, 'always' streams batches from disk, 'auto'
    streams when the feature file exceeds STREAM_THRESHOLD_BYTES."""
    if streaming not in ("auto", "never", "always"):
        raise ValueError(f"unknown streaming mode {streaming!r}")
    d = os.path.join(data_path, split)
    fpath = os.path.join(d, f"{split}.features.hkl")
    ppath = os.path.join(d, f"{split}.positions.hkl")
    stream = streaming == "always" or (
        streaming == "auto"
        and os.path.getsize(fpath) > STREAM_THRESHOLD_BYTES)
    if stream:
        features = open_hkl(fpath, dtype=np.float32)
        positions = open_hkl(ppath, dtype=np.float32)
    else:
        features = np.asarray(load_hkl(fpath), dtype=np.float32)
        positions = np.asarray(load_hkl(ppath), dtype=np.float32)
    captions = np.asarray(load_pickle(os.path.join(
        d, f"{split}.captions.pkl")), dtype=np.int32)
    image_idxs = np.asarray(load_pickle(os.path.join(
        d, f"{split}.image.indices.pkl")))
    file_names = np.asarray(load_pickle(os.path.join(
        d, f"{split}.file.names.pkl")))

    wpath = os.path.join(d, "word_index.pkl")
    word_to_idx = load_pickle(wpath) if os.path.exists(wpath) else None

    references = None
    rpath = os.path.join(d, f"{split}.references.pkl")
    if load_references and os.path.exists(rpath):
        references = load_pickle(rpath)

    if verbose:
        print(f"[data:{split}] {'streaming' if stream else 'in memory'}: "
              f"features {features.shape}, positions {positions.shape}, "
              f"captions {captions.shape}")
    return CocoSplit(features=features, positions=positions,
                     captions=captions, image_idxs=image_idxs,
                     file_names=file_names, word_to_idx=word_to_idx,
                     references=references)


def _pad_rows(arrs: List[np.ndarray], target: int) -> List[np.ndarray]:
    """Pad the batch dim by repeating row 0.  All-zero padding would give
    fully masked attention rows; repeating a real item keeps every mask
    well formed."""
    out = []
    for a in arrs:
        n = a.shape[0]
        if n == target:
            out.append(a)
        else:
            reps = np.repeat(a[:1], target - n, axis=0)
            out.append(np.concatenate([a, reps], axis=0))
    return out


class ImageBatches:
    """Decode batches, one item per unique image.  Yields ``(features
    [B,S,F], positions [B,S,P], image indices [B], real_count)``; the last
    batch is padded to B by repeating its row 0."""

    def __init__(self, split: CocoSplit, batch_size: int):
        self.split = split
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-self.split.num_images // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, int]]:
        n = self.split.num_images
        bs = self.batch_size
        for start in range(0, n, bs):
            sl = slice(start, min(start + bs, n))
            feats = self.split.features[sl]
            poss = self.split.positions[sl]
            idxs = np.arange(sl.start, sl.stop)
            real = len(idxs)
            if real < bs:
                feats, poss = _pad_rows([feats, poss], bs)
                idxs = np.pad(idxs, (0, bs - real))
            yield feats, poss, idxs, real
