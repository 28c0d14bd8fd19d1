"""Standalone text utilities (port of atq_tpu/data/text_utils.py, which no
command-line tool calls; part of the public API).

NLTK's tokenizer and stopword corpus are used when NLTK and its data are
present; otherwise deterministic fallbacks (regex word tokenization, a
built-in English stopword list) keep everything working offline. The probe
happens at each call and never raises; nothing is downloaded.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

# A compact English stopword list (fallback when nltk's corpus is absent).
_FALLBACK_STOPWORDS = frozenset(
    "a about above after again against all am an and any are as at be because"
    " been before being below between both but by could did do does doing"
    " down during each few for from further had has have having he her here"
    " hers herself him himself his how i if in into is it its itself just me"
    " more most my myself no nor not now of off on once only or other our"
    " ours ourselves out over own same she should so some such than that the"
    " their theirs them themselves then there these they this those through"
    " to too under until up very was we were what when where which while who"
    " whom why will with you your yours yourself yourselves".split()
)


def _word_tokenize(text: str) -> List[str]:
    try:
        import nltk

        nltk.data.find("tokenizers/punkt")
        return nltk.tokenize.word_tokenize(text)
    except Exception:
        return re.findall(r"\w+|[^\w\s]", text)


def _stopwords() -> frozenset:
    try:
        from nltk.corpus import stopwords

        return frozenset(stopwords.words("english"))
    except Exception:
        return _FALLBACK_STOPWORDS


def build_vocabulary(text_data: List[str], min_freq: int = 2,
                     max_size: int = 10000) -> Dict[str, int]:
    """Token -> id map with specials PAD=0 / UNK=1 / SOS=2 / EOS=3
    (text_utils.py:19-55)."""
    counter: Counter = Counter()
    for text in text_data:
        counter.update(_word_tokenize(text.lower()))
    vocab_tokens = [tok for tok, count in counter.most_common(max_size)
                    if count >= min_freq]
    vocab = {"<PAD>": 0, "<UNK>": 1, "<SOS>": 2, "<EOS>": 3}
    for i, token in enumerate(vocab_tokens):
        vocab[token] = i + 4
    return vocab


def clean_text(text: str) -> str:
    """Lowercase, strip punctuation/digits/stopwords (text_utils.py:57-81)."""
    text = text.lower()
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = re.sub(r"\d+", "", text)
    stop = _stopwords()
    return " ".join(w for w in text.split() if w not in stop)


def tokenize_texts(texts: List[str], vocab: Dict[str, int],
                   max_length: int = 100) -> Tuple[np.ndarray, List[int]]:
    """Batch-tokenize to a padded (B, max_length) int array + lengths
    (text_utils.py:83-108)."""
    token_ids = np.zeros((len(texts), max_length), dtype=np.int64)
    lengths = []
    for i, text in enumerate(texts):
        tokens = _word_tokenize(text.lower())
        lengths.append(min(len(tokens), max_length))
        for j, token in enumerate(tokens[:max_length]):
            token_ids[i, j] = vocab.get(token, vocab["<UNK>"])
    return token_ids, lengths


def create_embedding_matrix(vocab: Dict[str, int], embedding_dim: int = 300,
                            pretrained_file: Optional[str] = None,
                            seed: int = 0) -> np.ndarray:
    """Random N(0, 0.1) embedding matrix, PAD row zeroed, optionally
    overridden from a GloVe-format text file (text_utils.py:110-143)."""
    rng = np.random.RandomState(seed)
    matrix = rng.randn(len(vocab), embedding_dim).astype(np.float32) * 0.1
    matrix[vocab["<PAD>"]] = 0.0
    if pretrained_file:
        pretrained = {}
        with open(pretrained_file, "r", encoding="utf-8") as f:
            for line in f:
                values = line.strip().split()
                if len(values) != embedding_dim + 1:
                    continue
                pretrained[values[0]] = np.asarray(values[1:], np.float32)
        for word, idx in vocab.items():
            if word in pretrained:
                matrix[idx] = pretrained[word]
    return matrix
