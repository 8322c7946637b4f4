"""Caption evaluation harness — the ``core/evaluations.py:12-64`` equivalent.

``evaluate(...)`` loads ``{split}.references.pkl`` and
``{split}.candidate.captions.pkl`` from the reference-compatible layout and
scores BLEU-1..4 / METEOR / ROUGE-L / CIDEr / CIDEr-D.  METEOR always
reports a number: the jar when ``$ICX_METEOR_JAR`` is set (bit-parity with
the reference), the in-process METEOR 1.5 otherwise (metrics/meteor_native).
SPICE stays jar-gated and is skipped with a notice when absent — the
reference itself ships SPICE commented out (evaluations.py:19).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..utils.io import load_pickle
from .bleu import Bleu
from .cider import Cider, CiderD
from .meteor import Meteor, MeteorUnavailable
from .rouge import Rouge
from .spice import Spice, SpiceUnavailable


def score_captions(ref_captions: Dict, hypo_captions: Dict,
                   include_spice: bool = False,
                   verbose: bool = True) -> Dict[str, object]:
    """evaluations.py:12-34 with graceful Java gating.

    A jar-gated scorer that cannot run still appears in the result as the
    string ``"skipped (<reason>)"`` so score files stay comparable with
    reference runs (which always report METEOR, core/evaluations.py:16);
    numeric consumers must filter with ``is_scalar_score``.

    METEOR's value depends on the producing configuration (the jar runs 4
    English matcher stages; the in-process scorer runs whatever this
    environment supports — exact+stem without a WordNet corpus), so the
    result carries a ``METEOR_backend`` string (e.g. ``native[exact,stem]``)
    that ``write_scores`` persists next to the number: a scores file is
    only comparable with runs of the same backend (docs/parity.md)."""
    meteor = Meteor()
    scorers = [
        (Bleu(4), ["BLEU_1", "BLEU_2", "BLEU_3", "BLEU_4"]),
        (meteor, "METEOR"),
        (Rouge(), "ROUGE_L"),
        (Cider(), "CIDEr"),
        (CiderD(), "CIDEr-D"),
    ]
    if include_spice:
        scorers.append((Spice(), "SPICE"))

    final_scores: Dict[str, object] = {}
    for scorer, method in scorers:
        try:
            scores, _ = scorer.compute_score(gts=ref_captions,
                                             res=hypo_captions)
        except (MeteorUnavailable, SpiceUnavailable) as e:
            if verbose:
                print(f"[metrics] skipping {method}: {e}")
            final_scores[method] = f"skipped ({e})"
            continue
        if isinstance(scores, list):
            for name, s in zip(method, scores):
                final_scores[name] = s
        else:
            final_scores[method] = scores
        if method == "METEOR":
            final_scores["METEOR_backend"] = meteor.backend_detail()
    return final_scores


def is_scalar_score(value) -> bool:
    """True for real metric values, False for 'skipped (...)' markers."""
    return isinstance(value, (int, float))


def evaluate(target_dir: str, data_path: str, split: str = "valid",
             get_scores: bool = False,
             include_spice: bool = False) -> Optional[Dict[str, float]]:
    """evaluations.py:37-64: pickle-in, scores-out, printed table."""
    reference_path = os.path.join(data_path, split,
                                  f"{split}.references.pkl")
    candidate_path = os.path.join(target_dir,
                                  f"{split}.candidate.captions.pkl")

    reference_captions = load_pickle(reference_path)
    candidate_captions = load_pickle(candidate_path)

    hypo_captions = {i: [c] for i, c in enumerate(candidate_captions)}

    final_scores = score_captions(reference_captions, hypo_captions,
                                  include_spice=include_spice)

    print()
    for name, score in final_scores.items():
        print(f"{name}:\t{score}")
    print()

    if get_scores:
        return final_scores
    return None
