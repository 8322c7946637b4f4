"""Host-side self-critical rewards (string n-gram metrics on the CPU).

The counterpart of the JAX package's ``rl/rewards.py``, mirroring
``StructureCriterion`` (loss.py:96-216): a sentence's reward is
``cider_w * CIDEr-D(sample, target) + bleu_w * BLEU-4(sample, target)``,
scored one-vs-one on strings from ``decode_captions``, plus the self-CIDEr
diversity term.  The native scorer (``utils/native.py``) is used when it
builds and loads; the Python scorers are its oracle and the fallback.

One difference from the JAX package, on purpose: where the JAX constructor
swallows a native failure, this one issues a ``RuntimeWarning`` naming the
error before it falls back, and ``backend`` says which scorer runs.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np

from ..data.vocab import decode_captions
from ..metrics.bleu import Bleu
from ..metrics.cider import Cider, CiderD
from ..utils.native import NgramRewarder


def get_div(eigvals: np.ndarray) -> float:
    """loss.py:200-210: diversity from the gram matrix's eigenvalues.  A
    fully degenerate gram (all-zero tf-idf, possible only in corpus-df
    mode where idf is 0) gives 0, where the reference would give inf."""
    eigvals = np.clip(eigvals, 0, None)
    sqrt_top = np.sqrt(eigvals[-1])
    sqrt_sum = np.sqrt(eigvals).sum()
    if sqrt_top == 0:
        return 0.0
    log_n = np.log(len(eigvals))
    if sqrt_sum == 0:
        sqrt_sum = 1e-8
    if log_n == 0:
        log_n = 1e-8
    return float(-np.log(sqrt_top / sqrt_sum) / log_n)


class RewardComputer:
    """Batch rewards: int sequences -> per-sentence float32 rewards."""

    def __init__(self, word_to_idx: Dict[str, int], *,
                 cider_reward_weight: float = 1.0,
                 bleu_reward_weight: float = 1.0,
                 self_cider_reward_weight: float = 1.0,
                 cider_df: str = "coco-val",
                 use_native: bool = True):
        self.idx_to_word = {i: w for w, i in word_to_idx.items()}
        self.cider_w = float(cider_reward_weight)
        self.bleu_w = float(bleu_reward_weight)
        self.self_cider_w = float(self_cider_reward_weight)
        # scorers built once at start-up, like loss.py:112-116
        self.ciderD = CiderD(df=cider_df)
        self.cider = Cider(df=cider_df)
        self.bleu = Bleu(4, print_=False)
        self._native = None
        if use_native:
            try:
                self._native = NgramRewarder(
                    doc_frequency=self.ciderD.doc_frequency,
                    log_ref_len=(self.ciderD.log_ref_len
                                 if self.ciderD.doc_frequency else 0.0))
            except (OSError, RuntimeError) as exc:
                warnings.warn(
                    f"the native reward scorer is unavailable ({exc}); RL "
                    "rewards use the Python scorer", RuntimeWarning,
                    stacklevel=2)

    @property
    def backend(self) -> str:
        """'native' or 'python': the scorer of ``structure_scores``."""
        return "python" if self._native is None else "native"

    @property
    def uses_frozen_df(self) -> bool:
        """True when CIDEr-D scores against a loaded document-frequency
        table, so a row's reward does not depend on the other rows."""
        return self.ciderD.doc_frequency is not None

    def decode(self, seqs: np.ndarray) -> list:
        return decode_captions(np.asarray(seqs), self.idx_to_word)

    def structure_scores(self, sample_seq: np.ndarray,
                         target_seq: np.ndarray) -> np.ndarray:
        """loss.py:157-187: CIDEr-D + BLEU-4 per sentence, one-vs-one."""
        res_strs = self.decode(sample_seq)
        gts_strs = self.decode(target_seq)
        if self._native is not None:
            return self._native.structure_scores(res_strs, gts_strs,
                                                 self.cider_w, self.bleu_w)

        n = len(res_strs)
        res = {i: [res_strs[i]] for i in range(n)}
        gts = {i: [gts_strs[i]] for i in range(n)}
        cider_scores = bleu_scores = 0.0
        if self.cider_w > 0:
            _, cider_scores = self.ciderD.compute_score(gts, res)
        if self.bleu_w > 0:
            # the reference swallows BLEU failures (loss.py:176-181); the
            # scorer here handles empty strings, so an error is a bug
            _, bleu_all = self.bleu.compute_score(gts, res)
            bleu_scores = np.array(bleu_all[3])
        return (self.cider_w * np.asarray(cider_scores)
                + self.bleu_w * np.asarray(bleu_scores)).astype(np.float32)

    def self_cider_scores(self, sample_seq: np.ndarray,
                          group_size: int = 1) -> np.ndarray:
        """loss.py:189-216, per-sentence diversity.  ``group_size`` 1 is the
        reference's per-caption call: a 1x1 gram, whose ``get_div`` is 0
        for every input, so it returns exact zeros without scoring.
        ``group_size`` N scores one NxN tf-idf gram over each image's N
        consecutive samples and repeats its diversity across the group."""
        if group_size <= 1:
            return np.zeros((np.asarray(sample_seq).shape[0],), np.float32)
        res_strs = self.decode(sample_seq)
        if len(res_strs) % group_size:
            raise ValueError(f"{len(res_strs)} rows not divisible by "
                             f"group_size={group_size}")
        scores = []
        for i in range(0, len(res_strs), group_size):
            gram = self.cider.my_self_cider([res_strs[i:i + group_size]])[0]
            scores.append(get_div(np.linalg.eigvalsh(gram / 10.0)))
        return np.repeat(np.asarray(scores, dtype=np.float32), group_size)
