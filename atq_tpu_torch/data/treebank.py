"""Penn-Treebank-style word tokenizer (a copy of atq_tpu/data/treebank.py).

The JAX package vendors this dependency-free implementation of the PTB /
NLTK ``word_tokenize`` rules so that captions tokenize, and vocabulary ids
come out, as in a punkt-equipped reference run without NLTK data. The port
keeps its own copy (it imports nothing of the JAX package); the rules and
their order are unchanged, and tests/test_torch_retrieval_data.py holds the
two copies token for token on the recorded goldens.

On the caption pipeline's domain (lowercased captions with ``[^\\w\\s]``
stripped, data/flickr8k.py:clean_caption) the sentence split is the identity
and the rules reduce to whitespace splitting plus the six apostrophe-free
contraction splits (cannot/gimme/gonna/gotta/lemme/wanna). On raw text a
rule-based sentence split runs first; that path is best-effort.
"""

from __future__ import annotations

import re
from typing import List

# ---------------------------------------------------------------------------
# Rule tables: the MacIntyre/PTB sed-script semantics in NLTK's
# word_tokenize ordering. Each entry is (compiled pattern, replacement).
# ---------------------------------------------------------------------------

_STARTING_QUOTES = [
    # Unicode opening quotes and backtick runs become standalone tokens.
    (re.compile("([«“‘„]|[`]+)"), r" \1 "),
    # A double quote at string start is an opening quote.
    (re.compile(r'^"'), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    # Double quote (or '') after an opener is an opening quote.
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
    # Stanford-style clitic rule: split a leading apostrophe from the word
    # unless it starts a known clitic ('re 've 'll 'm 't 's 'd n't).
    (re.compile(r"(?i)(\')(?!re|ve|ll|m|t|s|d|n)(\w)\b"), r"\1 \2"),
]

_PUNCTUATION = [
    # Final period (with optional closers, incl. unicode closers).
    (re.compile(r'([^\.])(\.)([\]\)}>"\'»”’ ]*)\s*$'),
     r"\1 \2 \3 "),
    # Colon/comma split off unless followed by a digit (keeps 3,36 / 3:36).
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    # Ellipses of any length.
    (re.compile(r"\.{2,}"), r" \g<0> "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # Figure dash .. horizontal bar.
    (re.compile("[‒-―]"), r" \g<0> "),
    # Final period again (post colon/comma splits).
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"[*]"), r" \g<0> "),
]

_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")

_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

_ENDING_QUOTES = [
    (re.compile("([»”’])"), r" \1 "),
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"\s+"), " "),
    # Possessives and short clitics, then long clitics.
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

# MacIntyre two-part contractions; the only rules that can fire on the
# reference's CLEANED captions are the apostrophe-free six.
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(not)\b",
    r"(?i)\b(d)('ye)\b",
    r"(?i)\b(gim)(me)\b",
    r"(?i)\b(gon)(na)\b",
    r"(?i)\b(got)(ta)\b",
    r"(?i)\b(lem)(me)\b",
    r"(?i)\b(more)('n)\b",
    r"(?i)\b(wan)(na)(?=\s)",
)]
_CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(is)\b",
    r"(?i) ('t)(was)\b",
)]


def ptb_tokenize(text: str) -> List[str]:
    """Tokenize one sentence with the PTB/NLTK word rules.

    Equivalent to NLTK's ``NLTKWordTokenizer().tokenize(text)`` (the worker
    behind ``word_tokenize``) — pinned by tests/test_tokenizer_parity.py
    against the installed NLTK across caption corpora, quotes,
    contractions, numerals, and unicode punctuation.
    """
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    text = _PARENS_BRACKETS[0].sub(_PARENS_BRACKETS[1], text)
    text = _DOUBLE_DASHES[0].sub(_DOUBLE_DASHES[1], text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


# Lightweight sentence boundary rule for the general-text path: split after
# sentence-final punctuation (+ closing quotes/brackets) followed by
# whitespace and an upper-case/quote/bracket opener. Punkt is statistical;
# this rule matches it on simple prose and is irrelevant on the
# vocab-parity path (cleaned captions contain no boundary punctuation).
_SENT_BOUNDARY = re.compile(
    r"(?<=[.!?])([\"\'\)\]»”’]*)\s+"
    r"(?=[\"\'\(\[«“‘A-Z0-9])")


def sent_split(text: str) -> List[str]:
    """Best-effort punkt-style sentence split (identity on caption text)."""
    marked = _SENT_BOUNDARY.sub(lambda m: m.group(1) + "\x00", text)
    return [s for s in (p.strip() for p in marked.split("\x00")) if s]


def word_tokenize(text: str) -> List[str]:
    """Drop-in for ``nltk.tokenize.word_tokenize`` without NLTK data.

    Exact on the reference caption pipeline's domain (cleaned single
    sentences, where the punkt stage is the identity); best-effort on raw
    multi-sentence prose (rule-based sentence split).
    """
    return [tok for sent in sent_split(text) for tok in ptb_tokenize(sent)]
