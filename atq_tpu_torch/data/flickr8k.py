"""The serving half of the Flickr8k caption pipeline (port of
atq_tpu/data/flickr8k.py).

What retrieval serving needs: the special token ids, caption cleaning and
tokenization (the vendored PTB tokenizer, data/treebank.py, or
``ATQ_SPLIT_TOKENIZER=1`` for the punkt-less ``.split()``), the vocab file
readers and writer, the ImageNet normalization statistics, and the seeded
synthetic corpus and images that stand in for the dataset offline.

The JAX package also tries ``nltk.word_tokenize`` when NLTK's punkt data is
installed; on cleaned captions that branch is token-identical to the
vendored one (tests/test_tokenizer_parity.py), so the port leaves it out and
stamps vocab files ``vendored-ptb`` (or ``split``). The dataset, loaders and
visualization wait for the retrieval training slice (ROADMAP.md, slice E).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from atq_tpu_torch.data.treebank import word_tokenize

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

PAD, UNK, START, END = 0, 1, 2, 3
SPECIALS = {"<PAD>": PAD, "<UNK>": UNK, "<START>": START, "<END>": END}


def _split_tokenizer() -> bool:
    return os.environ.get("ATQ_SPLIT_TOKENIZER", "0") == "1"


def tokenize(caption: str) -> List[str]:
    """The vendored PTB tokenizer on the lowercased caption, or
    ``.split()`` under ``ATQ_SPLIT_TOKENIZER=1``."""
    if _split_tokenizer():
        return caption.lower().split()
    return word_tokenize(caption.lower())


def clean_caption(caption: str) -> str:
    """Lowercase and strip non-word characters."""
    return re.sub(r"[^\w\s]", "", caption.lower())


def active_tokenizer_variant() -> str:
    """``'split'`` or ``'vendored-ptb'``: what :func:`tokenize` uses now,
    stamped into saved vocab files."""
    return "split" if _split_tokenizer() else "vendored-ptb"


# Reserved metadata key inside a saved vocab JSON (not a token).
VOCAB_TOKENIZER_KEY = "__tokenizer__"


def read_vocab_tokenizer(path: str) -> Optional[str]:
    """The tokenizer variant stamped into a saved vocab file, or None for
    a file without the stamp (or one that cannot be read)."""
    try:
        with open(path) as f:
            return json.load(f).get(VOCAB_TOKENIZER_KEY)
    except (OSError, ValueError):
        return None


def load_vocab_file(path: str) -> Dict[str, int]:
    """A recorded word_to_idx vocabulary (JSON); metadata keys (``__*``)
    are stripped."""
    with open(path) as f:
        return {k: int(v) for k, v in json.load(f).items()
                if not k.startswith("__")}


def save_vocab_file(word_to_idx: Dict[str, int], path: str) -> None:
    record = dict(word_to_idx)
    record[VOCAB_TOKENIZER_KEY] = active_tokenizer_variant()
    with open(path, "w") as f:
        json.dump(record, f)


_SYN_SUBJECTS = ["a dog", "a child", "two men", "a woman", "a group",
                 "a cyclist", "a bird", "a surfer"]
_SYN_VERBS = ["runs", "jumps", "plays", "walks", "rides", "stands", "swims",
              "climbs"]
_SYN_PLACES = ["on the beach", "in the park", "near the water",
               "on a mountain", "in the snow", "on the street",
               "in the grass", "at the market"]


def _synthetic_corpus(n_images: int, seed: int = 0):
    """Deterministic (image name, 5 captions, latent) triples, as the JAX
    package draws them; the latent (subject, verb, place) sets the image's
    color pattern."""
    rng = np.random.RandomState(seed)
    names, captions, latents = [], {}, {}
    for i in range(n_images):
        s = rng.randint(len(_SYN_SUBJECTS))
        v = rng.randint(len(_SYN_VERBS))
        p = rng.randint(len(_SYN_PLACES))
        name = f"synthetic_{i:05d}.jpg"
        names.append(name)
        latents[name] = (s, v, p)
        caps = []
        for _ in range(5):
            extra = rng.choice(["happily", "quickly", "slowly", "outside",
                                "today", ""])
            cap = f"{_SYN_SUBJECTS[s]} {_SYN_VERBS[v]} {_SYN_PLACES[p]} " \
                  f"{extra}".strip()
            caps.append(clean_caption(cap))
        captions[name] = caps
    return names, captions, latents


def _synthetic_image(latent, image_size: int, seed: int) -> np.ndarray:
    """(image_size, image_size, 3) float32 in [0, 1] for a latent."""
    s, v, p = latent
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    yy /= image_size
    xx /= image_size
    r = 0.5 + 0.5 * np.sin(2 * np.pi * (s + 1) * xx)
    g = 0.5 + 0.5 * np.cos(2 * np.pi * (v + 1) * yy)
    b = 0.5 + 0.5 * np.sin(2 * np.pi * (p + 1) * (xx + yy))
    img = np.stack([r, g, b], axis=-1)
    img += rng.randn(image_size, image_size, 3).astype(np.float32) * 0.05
    return np.clip(img, 0, 1).astype(np.float32)


def synthetic_vocabulary(captions) -> Dict[str, int]:
    """The training vocabulary of a caption list: the specials, then every
    token seen at least 5 times, in first-seen order (the JAX dataset's
    ``_build_vocabulary``)."""
    counts: Dict[str, int] = {}
    for caption in captions:
        for tok in tokenize(caption):
            counts[tok] = counts.get(tok, 0) + 1
    vocab = dict(SPECIALS)
    for word, count in counts.items():
        if count >= 5:
            vocab[word] = len(vocab)
    return vocab
