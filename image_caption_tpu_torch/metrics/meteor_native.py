"""In-process METEOR 1.5 (Denkowski & Lavie 2014, "Meteor Universal").

The reference scores METEOR through coco-caption's Java subprocess on every
evaluation (``core/evaluations.py:8,16``; its Dockerfile
installs OpenJDK).  This module reimplements the meteor-1.5 English scoring
pipeline in Python so METEOR produces a NUMBER in jar-less environments
instead of a ``skipped (...)`` sentinel:

  * matcher modules in priority order — exact, stem (Snowball English, the
    same algorithm as the jar's org.tartarus.snowball), synonym (WordNet
    synset overlap; engaged only when the nltk WordNet corpus is
    installed).  The jar's fourth English stage — phrase-level paraphrase
    matching against ``data/paraphrase-en.gz`` — is NOT implemented (the
    aligner is word-to-word); environments that need it must score
    through the jar (``$ICX_METEOR_JAR``).  ``MeteorNative().stages``
    reports exactly the stages the aligner ran, and evaluations emit it
    as ``METEOR_backend`` so every persisted score names its producing
    configuration;
  * one-to-one alignment resolved by beam search maximizing, in order:
    covered words, fewer chunks, smaller sum of |i-j| match distances,
    earlier modules (the published Aligner criteria);
  * scoring with the released English defaults — alpha 0.85, beta 0.2,
    gamma 0.6, delta 0.75, module weights 1.0/0.6/0.8/0.6:
        P     = sum_i w_i (d·m_i(h_c) + (1-d)·m_i(h_f)) / (d|h_c|+(1-d)|h_f|)
        R     = likewise over the reference
        Fmean = P·R / (alpha·P + (1-alpha)·R)
        Pen   = gamma · (chunks / avg_matches)^beta
        score = (1 - Pen) · Fmean
  * multi-reference: each segment keeps the best-scoring reference's
    statistics (the jar's behavior), and the corpus "final" score is
    recomputed from the SUMMED statistics (the ``EVAL ||| stats`` micro
    aggregation of the -stdio protocol), not the mean of segment scores.

Fidelity note: this is a from-the-paper reimplementation validated by
hand-computed cases (tests/test_meteor.py); it is NOT yet pinned
bit-for-bit against the jar because this environment has no Java.  The
divergence risks are confined to (a) alignment tie-breaking inside the
beam, (b) the built-in function-word list (override with
``$ICX_METEOR_DATA/function.words`` — the jar's own list — when
available).  ``scripts/record_meteor_fixture.py`` records the jar's
output for the replay test the moment a jar exists.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

# released meteor-1.5 English defaults (language 'en', task 'rank')
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
MODULE_WEIGHTS = (1.0, 0.6, 0.8)        # exact, stem, synonym (the jar's
                                        # 4th stage, paraphrase at 0.6, is
                                        # jar-only — see module docstring)
BEAM_WIDTH = 64

# Built-in English function-word list (used when $ICX_METEOR_DATA does not
# provide the jar's function.words).  The jar derives its list from corpus
# frequency; this curated set covers the same closed classes: determiners,
# pronouns, prepositions, conjunctions, auxiliaries, particles,
# punctuation.  Divergences only shift the delta-weighting of individual
# words, never whether they can match.
_FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both few many
most other such what which who whom whose
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves
am is are was were be been being have has had having do does did doing
will would shall should may might must can could ought need dare
to of in on at by for with from into onto upon about against between
among through during before after above below under over out off down up
near
and or but nor so yet if then than as because while although though
since unless until when where how why whether that
not n't never neither either
there here
's ' " ` `` '' ( ) [ ] { } , . ! ? ; : - -- ...
""".split())


def normalize(text: str) -> List[str]:
    """The jar's ``-norm`` flag: lowercase + split punctuation into their
    own tokens + whitespace-tokenize.  Our caption strings are already
    lowercase space-separated PTB tokens, so this is a near no-op guard
    for raw inputs."""
    out: List[str] = []
    for tok in text.lower().split():
        cur = ""
        for c in tok:
            if c.isalnum() or c == "'":
                cur += c
            else:
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(c)
        if cur:
            out.append(cur)
    return out


class _Stages:
    """Matcher-module availability + caches (one instance per scorer).

    ``enabled`` restricts the stage set (e.g. ``("exact",)`` for the
    stage-ablation measurement in docs/parity.md); ``None`` = everything
    available in this environment.  "exact" is always on."""

    def __init__(self, enabled: Optional[Sequence[str]] = None):
        self._enabled = None if enabled is None else frozenset(enabled)
        self._stem = None
        if self._allows("stem"):
            try:                  # nltk is optional: without it, no stem
                from nltk.stem.snowball import SnowballStemmer
                self._stem = SnowballStemmer("english").stem
            except ImportError:
                self._stem = None
        self._stem_cache: Dict[str, str] = {}
        self._syn = None
        if self._allows("synonym"):
            try:                  # WordNet corpus is optional offline
                from nltk.corpus import wordnet
                wordnet.synsets("dog")      # force the LookupError now
                self._syn = wordnet
            except Exception:
                self._syn = None
        self._syn_cache: Dict[str, frozenset] = {}
        data_dir = os.environ.get("ICX_METEOR_DATA", "")
        if data_dir:
            fw = os.path.join(data_dir, "function.words")
            if os.path.exists(fw):
                with open(fw) as f:
                    self.function_words = frozenset(
                        w.strip() for w in f if w.strip())
            else:
                self.function_words = _FUNCTION_WORDS
        else:
            self.function_words = _FUNCTION_WORDS

    def _allows(self, stage: str) -> bool:
        return self._enabled is None or stage in self._enabled

    def stem(self, w: str) -> Optional[str]:
        if self._stem is None:
            return None                      # stage disabled: never matches
        s = self._stem_cache.get(w)
        if s is None:
            s = self._stem_cache[w] = self._stem(w)
        return s

    def synsets(self, w: str) -> frozenset:
        if self._syn is None:
            return frozenset()
        s = self._syn_cache.get(w)
        if s is None:
            s = self._syn_cache[w] = frozenset(
                ss.name() for ss in self._syn.synsets(w))
        return s

    def weight(self, w: str) -> float:
        return (1.0 - DELTA) if w in self.function_words else DELTA


# ---------------------------------------------------------------------------
# Alignment: one-to-one word matches via beam search
# ---------------------------------------------------------------------------

def _candidate_matches(hyp: Sequence[str], ref: Sequence[str],
                       st: _Stages) -> List[List[Tuple[int, int]]]:
    """Per hypothesis position: [(ref_pos, module)] candidates, module in
    {0 exact, 1 stem, 2 synonym}; only the best (lowest) module per
    (i, j) pair is kept — the jar likewise scores each matched pair once,
    with its highest-priority module."""
    ref_stems = [st.stem(w) for w in ref]
    ref_syns = [st.synsets(w) for w in ref]
    out: List[List[Tuple[int, int]]] = []
    for w in hyp:
        ws = st.stem(w)
        wsyn = st.synsets(w)
        cands: List[Tuple[int, int]] = []
        for j, rw in enumerate(ref):
            if w == rw:
                cands.append((j, 0))
            elif ws is not None and ws == ref_stems[j]:
                cands.append((j, 1))
            elif wsyn and not wsyn.isdisjoint(ref_syns[j]):
                cands.append((j, 2))
        out.append(cands)
    return out


def align(hyp: Sequence[str], ref: Sequence[str],
          st: _Stages) -> List[Tuple[int, int, int]]:
    """Resolve the one-to-one alignment: ``[(hyp_pos, ref_pos, module)]``.

    Beam search over hypothesis positions, ranking partial alignments by
    the published criteria: (1) maximize matched words, (2) minimize
    chunks, (3) minimize the summed |i-j| distance, (4) prefer
    earlier-priority modules.  Width ``BEAM_WIDTH`` — exhaustive for
    caption-length sentences in practice."""
    cands = _candidate_matches(hyp, ref, st)
    # state: (used_ref_bitmask, matches, chunks, dist, modsum, last_j,
    #         matchlist)
    states = [(0, 0, 0, 0, 0, -2, ())]
    for i, ci in enumerate(cands):
        nxt = []
        for (mask, m, ch, dist, ms, last_j, ml) in states:
            # skip this hypothesis word
            nxt.append((mask, m, ch, dist, ms, -2, ml))
            for (j, mod) in ci:
                bit = 1 << j
                if mask & bit:
                    continue
                new_ch = ch + (0 if j == last_j + 1 else 1)
                nxt.append((mask | bit, m + 1, new_ch,
                            dist + abs(i - j), ms + mod, j,
                            ml + ((i, j, mod),)))
        # rank: matches desc, chunks asc, dist asc, modules asc
        nxt.sort(key=lambda s: (-s[1], s[2], s[3], s[4]))
        # dedup identical ref-usage masks with identical last_j (same
        # future behavior): keep the best-ranked
        seen = set()
        states = []
        for s in nxt:
            key = (s[0], s[5])
            if key in seen:
                continue
            seen.add(key)
            states.append(s)
            if len(states) >= BEAM_WIDTH:
                break
    return list(states[0][6])


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

class SegmentStats:
    """The sufficient statistics of one (hyp, best-ref) pair — the
    in-process analogue of the jar's MeteorStats line.  Corpus scores are
    recomputed from FIELD-WISE SUMS (the ``EVAL ||| stats`` protocol),
    never by averaging segment scores."""

    __slots__ = ("w_mh", "w_lh", "w_mr", "w_lr", "chunks", "avg_matches")

    def __init__(self, w_mh=0.0, w_lh=0.0, w_mr=0.0, w_lr=0.0,
                 chunks=0.0, avg_matches=0.0):
        self.w_mh, self.w_lh = w_mh, w_lh
        self.w_mr, self.w_lr = w_mr, w_lr
        self.chunks, self.avg_matches = chunks, avg_matches

    def add(self, other: "SegmentStats") -> None:
        for f in self.__slots__:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def score(self) -> float:
        p = self.w_mh / self.w_lh if self.w_lh > 0 else 0.0
        r = self.w_mr / self.w_lr if self.w_lr > 0 else 0.0
        denom = ALPHA * p + (1.0 - ALPHA) * r
        fmean = (p * r / denom) if denom > 0 else 0.0
        if self.avg_matches > 0 and self.chunks > 0:
            frag = self.chunks / self.avg_matches
            pen = GAMMA * math.pow(frag, BETA)
        else:
            pen = 0.0
        return (1.0 - pen) * fmean


def _pair_stats(hyp_toks: List[str], ref_toks: List[str],
                st: _Stages) -> SegmentStats:
    matches = align(hyp_toks, ref_toks, st)
    w_lh = sum(st.weight(w) for w in hyp_toks)
    w_lr = sum(st.weight(w) for w in ref_toks)
    w_mh = w_mr = 0.0
    for (i, j, mod) in matches:
        w_mh += MODULE_WEIGHTS[mod] * st.weight(hyp_toks[i])
        w_mr += MODULE_WEIGHTS[mod] * st.weight(ref_toks[j])
    # chunk count over the final alignment, in hypothesis order: a new
    # chunk wherever hyp or ref adjacency breaks
    chunks = 0
    last = (-2, -2)
    for (i, j, _) in sorted(matches):
        if not (i == last[0] + 1 and j == last[1] + 1):
            chunks += 1
        last = (i, j)
    n = len(matches)
    return SegmentStats(w_mh, w_lh, w_mr, w_lr, float(chunks), float(n))


class MeteorNative:
    """Drop-in for the jar wrapper's ``compute_score(gts, res)`` API.

    ``stages`` restricts the matcher modules (ablation studies —
    docs/parity.md METEOR row); default = every stage available here."""

    def __init__(self, stages: Optional[Sequence[str]] = None):
        self._st = _Stages(enabled=stages)

    @property
    def stages(self) -> List[str]:
        """The matcher stages the aligner actually runs — NOT the jar's
        full English set: synonym needs the nltk WordNet corpus, and
        phrase-level paraphrase is jar-only (module docstring)."""
        names = ["exact"]
        if self._st._stem is not None:
            names.append("stem")
        if self._st._syn is not None:
            names.append("synonym")
        return names

    def score_pair(self, hypothesis: str,
                   references: Sequence[str]) -> Tuple[float, SegmentStats]:
        """Best reference's (score, stats) for one segment."""
        hyp_toks = normalize(hypothesis)
        best: Optional[Tuple[float, SegmentStats]] = None
        for ref in references:
            stats = _pair_stats(hyp_toks, normalize(ref), self._st)
            s = stats.score()
            if best is None or s > best[0]:
                best = (s, stats)
        if best is None:                      # no references
            return 0.0, SegmentStats()
        return best

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        total = SegmentStats()
        scores: List[float] = []
        for key in sorted(gts.keys()):
            assert len(res[key]) == 1
            # mirror the jar path's hypothesis sanitization exactly
            hypo = res[key][0].replace("|||", "").replace("  ", " ")
            s, stats = self.score_pair(hypo, gts[key])
            scores.append(s)
            total.add(stats)
        return total.score(), scores

    def method(self) -> str:
        return "METEOR"
