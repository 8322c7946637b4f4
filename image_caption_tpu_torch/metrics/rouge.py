"""ROUGE-L, compatible with coco-caption's rouge scorer
(``core.metrics.rouge.rouge`` — evaluations.py:5).

F_lcs with beta = 1.2 (Lin, 2004): for each reference take
``r = LCS/len(ref)``, ``p = LCS/len(cand)``; the instance score is the max
over references of ``((1+b^2) r p) / (r + b^2 p)``; the corpus score is the
mean over instances.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

BETA = 1.2


def lcs_length(a: List[str], b: List[str]) -> int:
    """Classic O(len(a)*len(b)) DP (small caption lengths)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return prev[len(b)]


def rouge_l_sentence(candidate: str, refs: List[str]) -> float:
    # split(" "), not split(): pycocoevalcap's rouge keeps the empty
    # tokens that runs of whitespace produce, and they count toward the
    # precision/recall denominators — bit-compat requires matching that
    cand_tokens = candidate.split(" ")
    prec, rec = [], []
    for ref in refs:
        ref_tokens = ref.split(" ")
        lcs = lcs_length(cand_tokens, ref_tokens)
        prec.append(lcs / float(len(cand_tokens)) if cand_tokens else 0.0)
        rec.append(lcs / float(len(ref_tokens)) if ref_tokens else 0.0)
    p, r = max(prec), max(rec)
    if p != 0 and r != 0:
        return ((1 + BETA ** 2) * p * r) / (r + BETA ** 2 * p)
    return 0.0


class Rouge:
    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = []
        for key in sorted(gts.keys()):
            hypo = res[key]
            assert isinstance(hypo, list) and len(hypo) == 1
            scores.append(rouge_l_sentence(hypo[0], gts[key]))
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "Rouge"
