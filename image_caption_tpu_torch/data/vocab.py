"""Vocabulary building, caption vectorization and detokenization, with the
reference's rules:

  * ``build_vocab``          — core/preprocess.py:283-311
  * ``build_caption_vector`` — core/preprocess.py:314-345
  * ``decode_captions``      — core/utils.py:67-103
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence

import numpy as np

from ..config import (END_IDX, END_TOKEN, NULL_IDX, NULL_TOKEN, START_IDX,
                      START_TOKEN, UNK_IDX, UNK_TOKEN)
from .tokenizer import ptb_tokenize


def build_vocab(captions: Iterable[str], threshold: int = 1,
                tokenize=ptb_tokenize) -> Dict[str, int]:
    """Count tokens across captions and keep those seen ``threshold`` times
    or more.  The special tokens take indices 0..3; words follow from 4 in
    first-seen order (core/preprocess.py:297-307)."""
    counts: Counter = Counter()
    for caption in captions:
        counts.update(tokenize(caption))
    word_index = {NULL_TOKEN: NULL_IDX, START_TOKEN: START_IDX,
                  END_TOKEN: END_IDX, UNK_TOKEN: UNK_IDX}
    index = 4
    for word in counts:
        if counts[word] >= threshold:
            word_index[word] = index
            index += 1
    return word_index


def build_caption_vector(captions: Sequence[str], word_index: Dict[str, int],
                         max_length: int = 49,
                         tokenize=ptb_tokenize) -> np.ndarray:
    """``<START> tokens <END>`` padded with ``<NULL>`` to ``max_length + 2``
    int32 slots (core/preprocess.py:314-345)."""
    out = np.zeros((len(captions), max_length + 2), dtype=np.int32)
    for i, caption in enumerate(captions):
        vec = [word_index[START_TOKEN]]
        vec += [word_index.get(w, word_index[UNK_TOKEN])
                for w in tokenize(caption)]
        vec.append(word_index[END_TOKEN])
        if len(vec) > max_length + 2:
            raise ValueError(f"caption {i} longer than max_length="
                             f"{max_length}: {caption!r}")
        out[i, :len(vec)] = vec
    return out


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
