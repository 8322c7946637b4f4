"""Corpus/sentence BLEU, bit-compatible with coco-caption's bleu scorer.

Re-implemented from the published algorithm (Papineni et al., 2002) with the
exact numerical conventions of pycocoevalcap's ``bleu_scorer.py`` (the module
the reference imports as ``core.metrics.bleu.bleu`` — evaluations.py:4,
loss.py:9,116):

  * tokenization = whitespace split of the pre-tokenized caption strings;
  * modified n-gram precision with per-ngram clipping against the max
    reference count;
  * reference length option "closest" (ties -> shorter);
  * smoothing constants ``small = 1e-9``, ``tiny = 1e-15`` applied as
    ``(correct + tiny) / (guess + small)``;
  * brevity penalty ``exp(1 - 1/ratio)`` with ``ratio = (testlen + tiny) /
    (reflen + small)`` applied when ratio < 1;
  * corpus score aggregates raw counts (not sentence means); per-sentence
    scores returned alongside, each with its OWN brevity penalty from that
    sentence's testlen/reflen ratio (exactly like bleu_scorer.py — the
    corpus-level BP applies only to the corpus score).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

SMALL = 1e-9
TINY = 1e-15


def precook(s: str, n: int = 4) -> Tuple[int, Dict[tuple, int]]:
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return len(words), counts


def cook_refs(refs: Sequence[str], n: int = 4):
    reflens = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        rl, counts = precook(ref, n)
        reflens.append(rl)
        for ngram, cnt in counts.items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), cnt)
    return reflens, maxcounts


def cook_test(test: str, reflens: List[int], refmaxcounts: Dict[tuple, int],
              n: int = 4):
    testlen, counts = precook(test, n)
    # "closest" reference length; ties go to the shorter ref
    reflen = min(reflens, key=lambda rl: (abs(rl - testlen), rl))

    result = {
        "testlen": testlen,
        "reflen": reflen,
        # (k+1)-gram slots in a testlen-word sentence: testlen - k
        "guess": [max(0, testlen - k) for k in range(n)],
        "correct": [0] * n,
    }
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(
            refmaxcounts.get(ngram, 0), count)
    return result


def _score_from_comps(comps: dict, n: int) -> List[float]:
    bleus = []
    logbleu = 0.0
    for k in range(n):
        logbleu += math.log(TINY + comps["correct"][k]) - \
            math.log(SMALL + comps["guess"][k])
        bleus.append(math.exp(logbleu / (k + 1)))
    ratio = (comps["testlen"] + TINY) / (comps["reflen"] + SMALL)
    if ratio < 1.0:
        bp = math.exp(1.0 - 1.0 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


class Bleu:
    """coco-caption-style interface: ``compute_score(gts, res)`` ->
    ``([bleu1..bleuN], [per-sentence lists])`` (evaluations.py:14,24)."""

    def __init__(self, n: int = 4, print_: bool = False):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        n = self.n
        total = {"testlen": 0, "reflen": 0,
                 "guess": [0] * n, "correct": [0] * n}
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        for key in sorted(gts.keys()):
            hypo = res[key]
            assert isinstance(hypo, list) and len(hypo) == 1
            reflens, refmax = cook_refs(gts[key], n)
            comps = cook_test(hypo[0], reflens, refmax, n)

            total["testlen"] += comps["testlen"]
            total["reflen"] += comps["reflen"]
            for k in range(n):
                total["guess"][k] += comps["guess"][k]
                total["correct"][k] += comps["correct"][k]

            sent = _score_from_comps(comps, n)
            for k in range(n):
                per_sentence[k].append(sent[k])

        corpus = _score_from_comps(total, n)
        return corpus, per_sentence

    def method(self) -> str:
        return "Bleu"
