"""ctypes binding of the native n-gram reward scorer.

``csrc/ngram_rewards.cpp`` (the port's copy of the JAX package's scorer)
is compiled by ``g++`` at first use into ``_build/`` (``ops/_build.py``).
``NgramRewarder`` scores the RL rewards (CIDEr-D + BLEU-4 one-vs-one, and
the single-sample self-CIDEr) on decoded strings; the Python scorers in
``metrics/`` are its oracle.  A frozen document-frequency table is hashed
and built into a C++ table once, when the scorer is made.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops import _build

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_STRS = ctypes.POINTER(ctypes.c_char_p)
_DF_ARGS = [_U64P, _F64P, ctypes.c_long, ctypes.c_double]


def _fnv1a(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def hash_ngram(ngram: Tuple[str, ...]) -> int:
    """The C++ key of an n-gram: words joined with 0x1f, FNV-1a 64."""
    return _fnv1a("\x1f".join(ngram).encode("utf-8"))


def _load_lib() -> ctypes.CDLL:
    lib = _build.load("ngram_rewards")
    lib.icx_df_create.argtypes = _DF_ARGS
    lib.icx_df_create.restype = ctypes.c_void_p
    lib.icx_df_destroy.argtypes = [ctypes.c_void_p]
    lib.icx_df_destroy.restype = None
    lib.icx_structure_scores_df.argtypes = [
        ctypes.c_void_p, _STRS, _STRS, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, _F32P]
    lib.icx_structure_scores_df.restype = None
    lib.icx_structure_scores.argtypes = [
        _STRS, _STRS, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        *_DF_ARGS, _F32P]
    lib.icx_structure_scores.restype = None
    lib.icx_self_cider_scores.argtypes = [_STRS, ctypes.c_int, *_DF_ARGS,
                                          _F32P]
    lib.icx_self_cider_scores.restype = None
    return lib


def _c_strings(strings: Sequence[str]):
    arr = (ctypes.c_char_p * len(strings))()
    arr[:] = [s.encode("utf-8") for s in strings]
    return arr


class NgramRewarder:
    """Native one-vs-one structure + self-CIDEr scorer.  Without a
    ``doc_frequency`` CIDEr-D takes its df from each call's references
    (corpus mode)."""

    def __init__(self, doc_frequency: Optional[Dict] = None,
                 log_ref_len: float = 0.0):
        self._lib = _load_lib()
        self._df_handle = None
        if doc_frequency:
            self._df_hashes = np.fromiter(
                (hash_ngram(g) for g in doc_frequency), dtype=np.uint64,
                count=len(doc_frequency))
            self._df_values = np.fromiter(
                doc_frequency.values(), dtype=np.float64,
                count=len(doc_frequency))
        else:
            self._df_hashes = np.zeros((0,), np.uint64)
            self._df_values = np.zeros((0,), np.float64)
        self._log_ref_len = float(log_ref_len)
        if len(self._df_hashes):
            # the frozen table is immutable for the run: build it once
            self._df_handle = ctypes.c_void_p(
                self._lib.icx_df_create(*self._df_args()))

    def __del__(self):
        handle = getattr(self, "_df_handle", None)
        if handle:
            self._lib.icx_df_destroy(handle)
            self._df_handle = None

    def _df_args(self):
        return (self._df_hashes.ctypes.data_as(_U64P),
                self._df_values.ctypes.data_as(_F64P),
                ctypes.c_long(len(self._df_hashes)),
                ctypes.c_double(self._log_ref_len))

    def structure_scores(self, res: Sequence[str], gts: Sequence[str],
                         cider_w: float, bleu_w: float) -> np.ndarray:
        """``cider_w * CIDEr-D(res_i, gts_i) + bleu_w * BLEU-4(res_i,
        gts_i)`` per pair, float32 [n]."""
        if len(res) != len(gts):
            raise ValueError(f"{len(res)} samples against {len(gts)} "
                             "references")
        n = len(res)
        out = np.zeros((n,), np.float32)
        res_c, gts_c = _c_strings(res), _c_strings(gts)
        if self._df_handle is not None:
            self._lib.icx_structure_scores_df(
                self._df_handle, res_c, gts_c, n, cider_w, bleu_w,
                out.ctypes.data_as(_F32P))
        else:
            self._lib.icx_structure_scores(
                res_c, gts_c, n, cider_w, bleu_w, *self._df_args(),
                out.ctypes.data_as(_F32P))
        return out

    def self_cider_scores(self, res: Sequence[str]) -> np.ndarray:
        """Each caption's self-CIDEr alone (a 1x1 gram), float32 [n]."""
        n = len(res)
        out = np.zeros((n,), np.float32)
        self._lib.icx_self_cider_scores(_c_strings(res), n,
                                        *self._df_args(),
                                        out.ctypes.data_as(_F32P))
        return out
