"""Host-side caption tokenization.

The reference tokenizes through a Stanford CoreNLP HTTP server
(``core/preprocess.py:22,261``) after first stripping
``. , ' " ( )`` and mapping ``&``->``and``, ``-``->space
(``core/preprocess.py:251-258``).  On those pre-cleaned, lowercased strings
CoreNLP's PTB tokenizer reduces to whitespace splitting plus separation of
residual punctuation, which :func:`ptb_tokenize` reproduces in pure Python
for the vocabulary builders, so no Java server is needed.
"""

from __future__ import annotations

import re
from typing import List

# Characters CoreNLP PTB treats as separate tokens and that survive the
# reference's cleaning pass (it removes . , ' " ( ) & -).
_PUNCT_SPLIT = re.compile(r"([!?;@#$%^*+=<>\\\[\]{}|~`])")
# ':' and '/' split EXCEPT between digits: both CoreNLP's PTBLexer number
# patterns and NLTK's independent TreebankWordTokenizer keep times (3:30)
# and numeric fractions (1/2) as single tokens; word compounds
# (indoor/outdoor) are split like CoreNLP 4.x's splitForwardSlash default.
_COLON_SLASH_SPLIT = re.compile(r"((?<!\d)[:/]|[:/](?!\d))")
_WS = re.compile(r"\s+")


def ptb_tokenize(text: str) -> List[str]:
    """PTB-style tokenization of a cleaned caption string.

    Matches CoreNLP output on the reference's cleaned inputs: whitespace
    split with residual punctuation split into its own tokens.
    """
    text = _PUNCT_SPLIT.sub(r" \1 ", text)
    text = _COLON_SLASH_SPLIT.sub(r" \1 ", text)
    return [t for t in _WS.split(text.strip()) if t]
