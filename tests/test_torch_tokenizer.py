"""The port's caption cleaning and tokenization (``data/tokenizer.py``)
against the JAX package's, caption by caption: the characters the
reference strips or maps (& - ( ) ' " , .), times and fractions that stay
one token (3:30, 1/2), word compounds that split (a/b), residual
punctuation and upper case."""

import pytest

from image_caption_tpu.data import tokenizer as JT
from image_caption_tpu_torch.data import tokenizer as TT

CAPTIONS = [
    "A man, riding his bike.",
    "Two dogs & a cat (playing).",
    "A well-lit room.",
    "The dog's bowl is \"empty\"",
    "It is 3:30 on the clock",
    "Half 1/2 a pizza, and an indoor/outdoor patio",
    "a/b testing: yes",
    "WHAT?! A CAT; ON A MAT...",
    "  lots   of\tspace\nhere  ",
    "price $5 + tax = 7% [approx] {ok} <sure> #1 @home ~tilde `tick` |bar|",
    "mother-in-law's (old) car, parked.",
    "",
    "A cat:dog ratio of 2:1 at 10/20/30",
    "Ünïcode café — naïve",
]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_clean_and_tokenize_equal_jax(caption):
    assert TT.clean_caption(caption) == JT.clean_caption(caption)
    for lower in (True, False):
        assert TT.tokenize_caption(caption, lower=lower) == \
            JT.tokenize_caption(caption, lower=lower)
    ours, theirs = TT.PTBTokenizer(), JT.PTBTokenizer()
    assert ours(caption) == theirs(caption)
    assert ours.tokenize(caption) == theirs.tokenize(caption)


def test_cleaning_rules():
    assert TT.clean_caption("A & B-C (d), 'e' \"f\".") == "A and B C d e f"
    assert TT.tokenize_caption("It's 3:30, a/b!") == \
        ["its", "3:30", "a", "/", "b", "!"]


def test_corenlp_tokenizer_delegates_to_the_parser(monkeypatch):
    """CoreNLPTokenizer hands text to nltk's CoreNLPParser at its url (a
    stand-in parser here: no server is contacted)."""
    import sys
    import types
    seen = {}

    class Parser:
        def __init__(self, url):
            seen["url"] = url

        def tokenize(self, text):
            seen["text"] = text
            return iter(text.split())

    parse = types.ModuleType("nltk.parse")
    parse.CoreNLPParser = Parser
    monkeypatch.setitem(sys.modules, "nltk", types.ModuleType("nltk"))
    monkeypatch.setitem(sys.modules, "nltk.parse", parse)
    tok = TT.CoreNLPTokenizer(url="http://localhost:9000")
    assert tok("a dog runs") == ["a", "dog", "runs"]
    assert tok.tokenize("two cats") == ["two", "cats"]
    assert seen == {"url": "http://localhost:9000", "text": "two cats"}
