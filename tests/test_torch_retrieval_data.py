"""The port's serving half of the caption pipeline (data/flickr8k.py and its
copy of the PTB tokenizer, data/treebank.py) against atq_tpu's.

Tokens, cleaned captions, the synthetic corpus and images, and the
vocabulary built from it must be identical; the vendored tokenizer must
give the recorded NLTK output of tests/data/tokenizer_goldens.json; a vocab
file round-trips between the two packages.
"""

import json
import os
import zlib

import numpy as np
import pytest

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.data.treebank import ptb_tokenize as jax_ptb_tokenize
from atq_tpu_torch.data import flickr8k as f8k
from atq_tpu_torch.data.treebank import ptb_tokenize, word_tokenize

GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                      "tokenizer_goldens.json")))["vectors"]


@pytest.fixture(autouse=True)
def _vendored_tokenizer(monkeypatch):
    """The JAX side takes NLTK's punkt path when its data is installed;
    pin it to the vendored tokenizer, which the port copies."""
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    monkeypatch.delenv("ATQ_SPLIT_TOKENIZER", raising=False)


@pytest.mark.parametrize("vec", GOLDENS,
                         ids=[v["raw"][:32] or "<empty>" for v in GOLDENS])
def test_tokenizer_matches_recorded_nltk(vec):
    assert f8k.clean_caption(vec["raw"]) == vec["cleaned"]
    assert word_tokenize(vec["cleaned"]) == vec["nltk_on_cleaned"]
    assert ptb_tokenize(vec["raw"].lower()) == vec["nltk_on_raw_lower"]
    assert ptb_tokenize(vec["raw"]) == jax_ptb_tokenize(vec["raw"])
    assert f8k.tokenize(vec["raw"]) == jax_f8k.tokenize(vec["raw"])


def test_synthetic_corpus_images_and_vocab_match_jax():
    names, captions, latents = f8k._synthetic_corpus(400)
    j_names, j_captions, j_latents = jax_f8k._synthetic_corpus(400)
    assert names == j_names and captions == j_captions
    assert latents == j_latents
    all_caps = [c for n in names for c in captions[n]]
    for cap in all_caps:
        assert f8k.tokenize(cap) == jax_f8k.tokenize(cap)
    # The JAX dataset's vocabulary over the same (train-split) captions.
    train = [c for n in names[:320] for c in captions[n]]
    vocab = f8k.synthetic_vocabulary(train)
    ds = jax_f8k.Flickr8kDataset.__new__(jax_f8k.Flickr8kDataset)
    ds.items = [(None, c) for c in train]
    jax_f8k.Flickr8kDataset._build_vocabulary(ds)
    assert vocab == ds.word_to_idx and list(vocab) == list(ds.word_to_idx)
    for name in names[:3]:
        seed = zlib.crc32(name.encode()) % 2 ** 31
        np.testing.assert_array_equal(
            f8k._synthetic_image(latents[name], 24, seed),
            jax_f8k._synthetic_image(j_latents[name], 24, seed))
    np.testing.assert_array_equal(f8k.IMAGENET_MEAN, jax_f8k.IMAGENET_MEAN)
    np.testing.assert_array_equal(f8k.IMAGENET_STD, jax_f8k.IMAGENET_STD)
    assert (f8k.PAD, f8k.UNK, f8k.START, f8k.END) == (
        jax_f8k.PAD, jax_f8k.UNK, jax_f8k.START, jax_f8k.END)
    assert f8k.SPECIALS == jax_f8k.SPECIALS


def test_split_tokenizer_flag(monkeypatch):
    monkeypatch.setenv("ATQ_SPLIT_TOKENIZER", "1")
    cap = "a dog is gonna catch it"
    assert f8k.tokenize(cap) == jax_f8k.tokenize(cap) == cap.split()
    assert f8k.active_tokenizer_variant() == "split"


def test_vocab_file_round_trips_between_the_packages(tmp_path):
    vocab = {**f8k.SPECIALS, "dog": 4, "runs": 5}
    path = str(tmp_path / "vocab.json")
    f8k.save_vocab_file(vocab, path)
    assert jax_f8k.load_vocab_file(path) == vocab
    assert f8k.read_vocab_tokenizer(path) == "vendored-ptb"
    assert jax_f8k.tokenizer_variants_compatible(
        f8k.read_vocab_tokenizer(path), jax_f8k.active_tokenizer_variant())
    jax_path = str(tmp_path / "jax_vocab.json")
    jax_f8k.save_vocab_file(vocab, jax_path)
    assert f8k.load_vocab_file(jax_path) == vocab
    assert f8k.read_vocab_tokenizer(jax_path) == \
        jax_f8k.read_vocab_tokenizer(jax_path)
    assert f8k.read_vocab_tokenizer(str(tmp_path / "missing.json")) is None
