"""CIDEr and CIDEr-D, compatible with the coco-caption / ruotianluo-style
scorers the reference uses (``core.metrics.cider`` / ``core.metrics.ciderD``
— evaluations.py:6-7; RL rewards loss.py:7-8,112-116 built with
``df='coco-val'``).

Algorithm (Vedantam et al., 2015):
  * n-gram TF-IDF vectors, n = 1..4: ``vec_n[g] = tf(g) * log(N / df(g))``
    computed as ``tf * (log_ref_len - log(max(1, df)))``;
  * CIDEr:   per-n cosine similarity, averaged over refs and n, x10;
  * CIDEr-D: numerator clips hyp counts at ref counts
    (``min(hyp, ref) * ref``) and multiplies by a length gaussian
    ``exp(-(len_h - len_r)^2 / (2 * sigma^2))``, sigma = 6.

Document frequency modes:
  * ``df='corpus'`` — df computed from the ground-truth corpus of the call
    (coco-caption default for evaluation);
  * ``df=<path>`` or ``df='coco-val'`` — frozen df pickle (the RL-reward
    configuration).  'coco-val' resolves via ``$ICX_CIDER_DF`` or
    ``./data/coco-val-df.p``; when the file is absent we fall back to corpus
    mode (flagged on the instance) so training still runs.

``my_self_cider`` reproduces the diversity gram matrix used by the self-CIDEr
reward (loss.py:198): pairwise tf-idf cosine similarity (no clipping, no
length penalty) summed over n.
"""

from __future__ import annotations

import math
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

SIGMA = 6.0
N_DEFAULT = 4
# ruotianluo's frozen coco-val corpus size (log document count)
COCO_VAL_LOG_REF_LEN = float(np.log(40504.0))


def precook(s: str, n: int = N_DEFAULT) -> Dict[tuple, int]:
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class _CiderBase:
    def __init__(self, n: int = N_DEFAULT, sigma: float = SIGMA,
                 df: str = "corpus"):
        self.n = n
        self.sigma = sigma
        self.df_mode = df
        self.doc_frequency: Optional[Dict[tuple, float]] = None
        self.log_ref_len: Optional[float] = None
        self.df_fallback = False
        if df != "corpus":
            self._load_df(df)

    def _load_df(self, df: str) -> None:
        path = df
        if df == "coco-val":
            path = os.environ.get("ICX_CIDER_DF", "./data/coco-val-df.p")
        if not os.path.exists(path):
            # run in corpus mode; callers can check .df_fallback
            self.df_fallback = True
            return
        with open(path, "rb") as f:
            blob = pickle.load(f, encoding="latin1")
        if isinstance(blob, dict) and "document_frequency" in blob:
            self.doc_frequency = blob["document_frequency"]
            # the published ruotianluo coco-val-df.p stores ref_len as the
            # RAW document count (prepro_ngrams.py: ref_len = count_imgs)
            # and the scorer logs it at load (ciderD_scorer.py:
            # np.log(float(pkl_file['ref_len']))) — treating it as
            # pre-logged would silently erase idf weighting for the real
            # published blob
            if "ref_len" in blob:
                ref_len = float(blob["ref_len"])
                # Three on-disk generations of this field:
                #   * blobs written by build_doc_frequency since r3 carry
                #     df_format='raw_count' (authoritative);
                #   * the published ruotianluo blob and unmarked re-builds
                #     store the RAW (integral) document count;
                #   * blobs written by this repo's pre-r3
                #     build_doc_frequency stored log(N) — a non-integral
                #     value for every real corpus.  Re-logging one of
                #     those would silently corrupt every idf term, so the
                #     integrality of the value disambiguates.
                if blob.get("df_format") == "raw_count" or \
                        ref_len.is_integer():
                    self.log_ref_len = float(np.log(max(ref_len, 1.0)))
                else:
                    import warnings
                    warnings.warn(
                        "coco-val df stores a non-integral ref_len "
                        f"({ref_len!r}) — treating it as the PRE-LOGGED "
                        "log(N) this repo wrote before r3.  Re-run "
                        "scripts/build_cider_df.py to refresh the blob.",
                        stacklevel=2)
                    self.log_ref_len = ref_len
            else:
                self.log_ref_len = COCO_VAL_LOG_REF_LEN
        else:
            self.doc_frequency = blob
            self.log_ref_len = COCO_VAL_LOG_REF_LEN

    # -- tf-idf machinery ---------------------------------------------------

    def _compute_corpus_df(self, gts: Dict) -> Dict[tuple, float]:
        df: Dict[tuple, float] = defaultdict(float)
        for key in gts:
            seen = set()
            for ref in gts[key]:
                seen.update(precook(ref, self.n).keys())
            for g in seen:
                df[g] += 1.0
        return df

    def _counts2vec(self, counts: Dict[tuple, int], df: Dict[tuple, float],
                    log_ref_len: float):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in counts.items():
            dfv = math.log(max(1.0, df.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * (log_ref_len - dfv)
            norm[k] += vec[k][ngram] ** 2
            if k == 0:
                length += tf
        norm = [math.sqrt(v) for v in norm]
        return vec, norm, length

    def _sim(self, vec_hyp, norm_hyp, len_hyp, vec_ref, norm_ref, len_ref,
             *, clip: bool, length_penalty: bool) -> np.ndarray:
        delta = float(len_hyp - len_ref)
        val = np.zeros(self.n)
        for k in range(self.n):
            for ngram, hv in vec_hyp[k].items():
                rv = vec_ref[k].get(ngram, 0.0)
                h = min(hv, rv) if clip else hv
                val[k] += h * rv
            if norm_hyp[k] != 0 and norm_ref[k] != 0:
                val[k] /= norm_hyp[k] * norm_ref[k]
            if length_penalty:
                val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def _score_all(self, gts: Dict, res: Dict, *, clip: bool,
                   length_penalty: bool):
        if self.doc_frequency is not None:
            df, log_ref_len = self.doc_frequency, self.log_ref_len
        else:
            df = self._compute_corpus_df(gts)
            log_ref_len = math.log(max(float(len(gts)), 1e-12))

        scores = []
        for key in sorted(gts.keys()):
            hypo = res[key]
            assert isinstance(hypo, list) and len(hypo) == 1
            vec_h, norm_h, len_h = self._counts2vec(
                precook(hypo[0], self.n), df, log_ref_len)
            score = np.zeros(self.n)
            for ref in gts[key]:
                vec_r, norm_r, len_r = self._counts2vec(
                    precook(ref, self.n), df, log_ref_len)
                score += self._sim(vec_h, norm_h, len_h,
                                   vec_r, norm_r, len_r,
                                   clip=clip, length_penalty=length_penalty)
            score_avg = np.mean(score) / max(len(gts[key]), 1)
            scores.append(score_avg * 10.0)
        scores = np.array(scores)
        return float(np.mean(scores)), scores

    # -- diversity gram matrix (self-CIDEr reward, loss.py:189-216) ---------

    def my_self_cider(self, tests: Sequence[List[str]]) -> List[np.ndarray]:
        """For each caption set, the pairwise tf-idf cosine similarity
        matrix summed over n (no clipping / length penalty)."""
        if self.doc_frequency is not None:
            df, log_ref_len = self.doc_frequency, self.log_ref_len
        else:
            df = defaultdict(float)
            log_ref_len = 0.0
        out = []
        for captions in tests:
            vecs = [self._counts2vec(precook(c, self.n), df, log_ref_len)
                    for c in captions]
            m = len(captions)
            gram = np.zeros((m, m))
            for i in range(m):
                for j in range(m):
                    gram[i, j] = np.sum(self._sim(
                        vecs[i][0], vecs[i][1], vecs[i][2],
                        vecs[j][0], vecs[j][1], vecs[j][2],
                        clip=False, length_penalty=False))
            out.append(gram)
        return out


class Cider(_CiderBase):
    """Plain CIDEr (evaluations.py:17)."""

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        return self._score_all(gts, res, clip=False, length_penalty=False)

    def method(self) -> str:
        return "CIDEr"


class CiderD(_CiderBase):
    """CIDEr-D: clipped counts + length gaussian (evaluations.py:18)."""

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        return self._score_all(gts, res, clip=True, length_penalty=True)

    def method(self) -> str:
        return "CIDEr-D"


# ---------------------------------------------------------------------------
# Frozen document-frequency construction (the 'coco-val' df the reference's
# RL scorers are built with, loss.py:112-116)
# ---------------------------------------------------------------------------

def build_doc_frequency(caption_groups, n: int = N_DEFAULT) -> Dict:
    """df blob from an iterable of per-image caption lists.

    Returns the on-disk layout ``{"document_frequency": {ngram: df},
    "ref_len": N_docs}`` that ``_load_df`` consumes — ``ref_len`` is the
    RAW document count, logged at load, exactly like the published
    ruotianluo coco-val-df.p (prepro_ngrams.py)."""
    df: Dict[tuple, float] = defaultdict(float)
    n_docs = 0
    for captions in caption_groups:
        n_docs += 1
        seen = set()
        for c in captions:
            seen.update(precook(c, n).keys())
        for g in seen:
            df[g] += 1.0
    return {"document_frequency": dict(df),
            "ref_len": float(max(n_docs, 1)),
            # authoritative format marker: _load_df must not have to
            # guess whether ref_len is a raw count or pre-logged
            "df_format": "raw_count"}


def save_doc_frequency(blob: Dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(blob, f, pickle.HIGHEST_PROTOCOL)
