"""Detokenization with the reference's rules (core/utils.py:67-103)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import END_TOKEN, NULL_TOKEN, START_TOKEN


def invert_vocab(word_index: Dict[str, int]) -> Dict[int, str]:
    return {i: w for w, i in word_index.items()}


def decode_captions(captions: np.ndarray,
                    index_to_word: Dict[int, str]) -> List[str]:
    """Index sequences -> strings: skip <START> at t=0, <END> appends '.'
    and stops, <NULL> is skipped, words are joined by single spaces.  (The
    reference's 'a'->'an' branch is unreachable and is not reproduced.)"""
    captions = np.asarray(captions)
    if captions.ndim == 1:
        captions = captions[None, :]

    decoded: List[str] = []
    for row in captions:
        words: List[str] = []
        for t, idx in enumerate(row):
            word = index_to_word[int(idx)]
            if word == START_TOKEN and t == 0:
                continue
            if word == END_TOKEN:
                words.append(".")
                break
            if word != NULL_TOKEN:
                words.append(word)
        decoded.append(" ".join(words))
    return decoded
