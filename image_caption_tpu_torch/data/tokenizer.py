"""Host-side caption tokenization.

The reference tokenizes through a Stanford CoreNLP HTTP server
(``core/preprocess.py:22,261``) after first stripping
``. , ' " ( )`` and mapping ``&``->``and``, ``-``->space
(``core/preprocess.py:251-258``).  On those pre-cleaned, lowercased strings
CoreNLP's PTB tokenizer reduces to whitespace splitting plus separation of
residual punctuation, which :func:`ptb_tokenize` reproduces in pure Python
for the vocabulary code and the offline ETL, so no Java server is
needed.  ``CoreNLPTokenizer`` talks to such a server where one is
configured, as the byte-exact oracle.
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


def clean_caption(caption: str) -> str:
    """The reference's pre-tokenization cleanup (core/preprocess.py:251-258)."""
    caption = (caption.replace(".", "")
                      .replace(",", "")
                      .replace("'", "")
                      .replace('"', ""))
    caption = (caption.replace("&", "and")
                      .replace("(", "")
                      .replace(")", "")
                      .replace("-", " "))
    return caption


def ptb_tokenize(text: str) -> List[str]:
    """PTB-style tokenization of a cleaned caption string.

    Matches CoreNLP output on the reference's cleaned inputs: whitespace
    split with residual punctuation split into its own tokens.
    """
    text = _PUNCT_SPLIT.sub(r" \1 ", text)
    text = _COLON_SLASH_SPLIT.sub(r" \1 ", text)
    return [t for t in _WS.split(text.strip()) if t]


def tokenize_caption(caption: str, lower: bool = True) -> List[str]:
    """The reference's whole path: clean, lowercase, tokenize
    (core/preprocess.py:250-263)."""
    caption = clean_caption(caption)
    if lower:
        caption = caption.lower()
    return ptb_tokenize(caption)


class PTBTokenizer:
    """Callable tokenizer object (in-process, no Java)."""

    def tokenize(self, text: str) -> List[str]:
        return ptb_tokenize(text)

    def __call__(self, text: str) -> List[str]:
        return ptb_tokenize(text)


class CoreNLPTokenizer:
    """Byte-exact CoreNLP tokenization through a server at ``url``, as
    ``nltk.parse.CoreNLPParser(url=...).tokenize`` (core/preprocess.py:22).
    Used only where a server is configured; everything else in the package
    uses :func:`ptb_tokenize`."""

    def __init__(self, url: str = "http://localhost:9000"):
        from nltk.parse import CoreNLPParser   # needs nltk and a server
        self._parser = CoreNLPParser(url=url)

    def tokenize(self, text: str) -> List[str]:
        return list(self._parser.tokenize(text))

    def __call__(self, text: str) -> List[str]:
        return self.tokenize(text)
