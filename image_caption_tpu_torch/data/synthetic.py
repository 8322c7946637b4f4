"""Synthetic COCO-format dataset in the reference's on-disk layout.

The port's own copy of the JAX package's generator: from the same seed it
writes the same files with the same contents (``core/utils.py:32-64``
layout), so tests and smoke runs need no MS-COCO.  Captions come from a toy
grammar so the metrics are not degenerate; features are random with
zero-padded tail slots.  ``feature_format="npy"`` writes the two feature
files as ``.npy`` for a machine without ``h5py``.

    python -m image_caption_tpu_torch.data.synthetic PATH [--format npy]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from ..metrics.cider import build_doc_frequency, save_doc_frequency
from ..utils.io import save_array, save_pickle
from .vocab import build_caption_vector, build_vocab

_SUBJECTS = ["a man", "a woman", "a dog", "a cat", "a group of people",
             "two birds", "a child"]
_VERBS = ["riding", "holding", "watching", "standing near", "playing with",
          "sitting on"]
_OBJECTS = ["a bicycle", "a red ball", "an umbrella", "the beach",
            "a wooden bench", "a plate of food", "a laptop"]


def _random_caption(rng: np.random.RandomState) -> str:
    return " ".join([_SUBJECTS[rng.randint(len(_SUBJECTS))],
                     _VERBS[rng.randint(len(_VERBS))],
                     _OBJECTS[rng.randint(len(_OBJECTS))]])


def generate_synthetic_dataset(
        data_path: str, *, num_images: Optional[Dict[str, int]] = None,
        captions_per_image: int = 5, num_slots: int = 37,
        dim_features: int = 2048, dim_positions: int = 84,
        max_length: int = 49, seed: int = 0,
        feature_format: str = "hkl") -> Dict[str, int]:
    """Write train/valid/test splits under ``data_path``; returns the vocab."""
    if feature_format not in ("hkl", "npy"):
        raise ValueError(f"feature_format is 'hkl' or 'npy', "
                         f"not {feature_format!r}")
    num_images = num_images or {"train": 24, "valid": 8, "test": 8}
    rng = np.random.RandomState(seed)

    # shared vocab from the train captions (features.py:52-55 flow)
    all_caps: Dict[str, List[str]] = {}
    for split, n in num_images.items():
        all_caps[split] = [_random_caption(rng)
                           for _ in range(n * captions_per_image)]
    word_to_idx = build_vocab(all_caps["train"], threshold=1)

    for split, n in num_images.items():
        d = os.path.join(data_path, split)
        os.makedirs(d, exist_ok=True)
        caps = all_caps[split]

        feats = rng.randn(n, num_slots, dim_features).astype(np.float32)
        poss = rng.rand(n, num_slots, dim_positions).astype(np.float32)
        for i in range(n):
            k = rng.randint(2, num_slots)
            feats[i, k:] = 0.0
            poss[i, k:] = 0.0

        vectors = build_caption_vector(caps, word_to_idx,
                                       max_length=max_length)
        image_idxs = np.repeat(np.arange(n), captions_per_image)
        file_names = np.asarray([f"{split}_{i:06d}.jpg" for i in range(n)])
        references = {i: [caps[i * captions_per_image + j].lower() + " ."
                          for j in range(captions_per_image)]
                      for i in range(n)}

        save_array(feats, os.path.join(
            d, f"{split}.features.{feature_format}"))
        save_array(poss, os.path.join(
            d, f"{split}.positions.{feature_format}"))
        save_pickle(vectors, os.path.join(d, f"{split}.captions.pkl"))
        save_pickle(image_idxs, os.path.join(
            d, f"{split}.image.indices.pkl"))
        save_pickle(file_names, os.path.join(d, f"{split}.file.names.pkl"))
        save_pickle(references, os.path.join(d, f"{split}.references.pkl"))
        if split == "train":
            save_pickle(word_to_idx, os.path.join(d, "word_index.pkl"))
        if split == "valid":
            # frozen CIDEr df over the valid references, as the real ETL
            # writes it (loss.py:112-116 df='coco-val')
            save_doc_frequency(build_doc_frequency(references.values()),
                               os.path.join(data_path, "coco-val-df.p"))
    return word_to_idx


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m image_caption_tpu_torch.data.synthetic")
    p.add_argument("path", nargs="?", default="./data/synthetic")
    p.add_argument("--format", choices=("hkl", "npy"), default="hkl",
                   help="feature file format (npy needs no h5py)")
    args = p.parse_args(argv)
    vocab = generate_synthetic_dataset(args.path, feature_format=args.format)
    print(f"wrote synthetic dataset to {args.path} (vocab={len(vocab)})")


if __name__ == "__main__":
    main()
