"""The Flickr8k caption pipeline (port of atq_tpu/data/flickr8k.py).

- Serving: the special token ids, caption cleaning and tokenization (the
  vendored PTB tokenizer, data/treebank.py, or ``ATQ_SPLIT_TOKENIZER=1``
  for the punkt-less ``.split()``), the vocab file readers and writer, the
  ImageNet normalization statistics, and the seeded synthetic corpus and
  images that stand in for the dataset offline.
- Training: :class:`Flickr8kDataset` (one item per (image, caption) pair,
  the vocabulary of the train captions with minimum count 5, captions
  capped and padded with START/END), :class:`Flickr8kLoader` and
  :func:`prepare_flickr8k_dataloaders`. The batches per seed are the JAX
  package's: the shuffle is ``RandomState(seed + epoch)``'s permutation and
  an item's flip draws from ``RandomState(seed + index)``. ``raw_uint8``
  hands the trainer uint8 images to normalize and flip on the device;
  ``with_image_ids`` adds each pair's image index to the batch.

The real dataset is read from ``root_dir`` when it holds
``Flicker8k_Dataset/`` and ``Flickr8k.token.txt``; nothing is downloaded.
Without either, the synthetic corpus stands in; with one but not the other
the loader raises and names what is missing. Decoding real images needs
PIL, imported only on that branch.

The JAX package also tries ``nltk.word_tokenize`` when NLTK's punkt data is
installed; on cleaned captions that branch is token-identical to the
vendored one (tests/test_tokenizer_parity.py), so the port leaves it out and
stamps vocab files ``vendored-ptb`` (or ``split``). The samples plot
(``visualize_flickr8k_samples``) is not ported.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

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

# Variants that give the same tokens: the JAX package's NLTK punkt
# tokenizer and the vendored Penn Treebank one.
_PTB_COMPATIBLE = {"nltk-punkt", "vendored-ptb"}


def tokenizer_variants_compatible(a: str, b: str) -> bool:
    """Whether a vocab stamped ``a`` gives the right ids under tokenizer
    ``b`` (evaluate.py's tokenizer-stamp guard)."""
    return a == b or (a in _PTB_COMPATIBLE and b in _PTB_COMPATIBLE)


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


_REQUIRED = ("Flicker8k_Dataset", "Flickr8k.token.txt")
_SPLIT_FILES = {"train": "Flickr_8k.trainImages.txt",
                "val": "Flickr_8k.devImages.txt",
                "test": "Flickr_8k.testImages.txt"}


class Flickr8kDataset:
    """(image, caption) pairs with the reference's vocabulary."""

    def __init__(self, root_dir: str = "./data/flickr8k",
                 split: str = "train", image_size: int = 224,
                 max_length: int = 50, tokenize_captions: bool = True,
                 train_transform: bool = False,
                 vocab: Optional[Dict[str, int]] = None,
                 synthetic_images: int = 400, seed: int = 0,
                 cache_images: bool = True, raw_uint8: bool = False):
        self.raw_uint8 = raw_uint8
        self._image_cache: Optional[dict] = {} if cache_images else None
        self.root_dir = root_dir
        self.split = split
        self.image_size = image_size
        self.max_length = max_length
        self.tokenize_captions = tokenize_captions
        self.train_transform = train_transform
        self.seed = seed
        present = [f for f in _REQUIRED
                   if os.path.exists(os.path.join(root_dir, f))]
        if len(present) == 1:
            missing = [f for f in _REQUIRED if f not in present]
            raise FileNotFoundError(
                f"{root_dir} holds {present[0]} but not {missing[0]}: place "
                f"the extracted Flickr8k_Dataset.zip (Flicker8k_Dataset/) and "
                f"Flickr8k_text.zip (Flickr8k.token.txt and the "
                f"Flickr_8k.*Images.txt split files) there")
        self.synthetic = not present
        if self.synthetic:
            self._load_synthetic(synthetic_images)
        else:
            self._load_real()
        if tokenize_captions:
            if vocab is not None:
                self.word_to_idx = vocab
            else:
                self.word_to_idx = synthetic_vocabulary(
                    c for _, c in self.items)
                print(f"Vocabulary size: {len(self.word_to_idx)}")
            self.idx_to_word = {i: w for w, i in self.word_to_idx.items()}
            self.vocab_size = len(self.word_to_idx)

    def _load_real(self):
        captions: Dict[str, List[str]] = {}
        with open(os.path.join(self.root_dir, "Flickr8k.token.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or "\t" not in line:
                    continue
                image_caption_id, caption = line.split("\t", 1)
                captions.setdefault(image_caption_id.split("#")[0],
                                    []).append(clean_caption(caption))
        self.captions = captions
        paths = {k: os.path.join(self.root_dir, v)
                 for k, v in _SPLIT_FILES.items()}
        if all(os.path.exists(p) for p in paths.values()):
            with open(paths[self.split]) as f:
                self.image_names = [ln.strip() for ln in f if ln.strip()]
        else:  # an 80/10/10 split, written beside the data
            all_images = sorted(captions)
            np.random.RandomState(self.seed).shuffle(all_images)
            n_train = int(0.8 * len(all_images))
            n_val = int(0.1 * len(all_images))
            splits = {"train": all_images[:n_train],
                      "val": all_images[n_train:n_train + n_val],
                      "test": all_images[n_train + n_val:]}
            for k, p in paths.items():
                try:
                    with open(p, "w") as f:
                        f.write("\n".join(splits[k]))
                except OSError:
                    pass
            self.image_names = splits[self.split]
        self._latents = None
        self._make_items()

    def _load_synthetic(self, n_images: int):
        names, captions, latents = _synthetic_corpus(n_images, seed=0)
        n_train = int(0.8 * len(names))
        n_val = int(0.1 * len(names))
        splits = {"train": names[:n_train],
                  "val": names[n_train:n_train + n_val],
                  "test": names[n_train + n_val:]}
        self.captions = captions
        self.image_names = splits[self.split]
        self._latents = latents
        self._make_items()

    def _make_items(self):
        self.items = [(name, caption) for name in self.image_names
                      for caption in self.captions.get(name, [])]
        name_to_id = {n: i for i, n in enumerate(self.image_names)}
        self.item_image_ids = np.asarray(
            [name_to_id[name] for name, _ in self.items], np.int32)
        print(f"Loaded {len(self.items)} image-caption pairs for "
              f"{self.split} split")

    def __len__(self):
        return len(self.items)

    def _decode(self, name: str) -> np.ndarray:
        """(size, size, 3) float32 in [0, 1]."""
        if self.synthetic:
            return _synthetic_image(self._latents[name], self.image_size,
                                    seed=zlib.crc32(name.encode()) % 2 ** 31)
        from PIL import Image

        path = os.path.join(self.root_dir, "Flicker8k_Dataset", name)
        with Image.open(path) as im:
            im = im.convert("RGB").resize((self.image_size, self.image_size))
            return np.asarray(im, np.float32) / 255.0

    def _load_image(self, name: str, rng) -> np.ndarray:
        img = (self._image_cache.get(name)
               if self._image_cache is not None else None)
        if img is None:
            raw = self._decode(name)
            if self.raw_uint8:
                img = np.round(raw * 255.0).astype(np.uint8)
            else:
                img = (raw - IMAGENET_MEAN) / IMAGENET_STD
            if self._image_cache is not None:
                self._image_cache[name] = img
        if self.raw_uint8:  # normalized and flipped on the device
            return img
        if self.train_transform and rng.rand() < 0.5:
            img = img[:, ::-1]
        return img

    def encode_caption(self, caption: str) -> Tuple[np.ndarray, int]:
        tokens = tokenize(caption)
        ids = [START] + [self.word_to_idx.get(t, UNK) for t in tokens] \
            + [END]
        ids = ids[:self.max_length]
        length = min(len(tokens) + 2, self.max_length)
        ids = ids + [PAD] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32), length

    def __getitem__(self, idx: int):
        name, caption = self.items[idx]
        rng = np.random.RandomState((self.seed + idx) % 2 ** 31)
        image = self._load_image(name, rng)
        if self.tokenize_captions:
            ids, length = self.encode_caption(caption)
            return image, ids, length
        return image, caption, len(caption.split())


class Flickr8kLoader:
    """Batches of (images NHWC, caption ids (B, L) int32, lengths (B,)
    int32[, image ids (B,) int32]) as numpy arrays."""

    def __init__(self, dataset: Flickr8kDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = False,
                 with_image_ids: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.with_image_ids = with_image_ids
        # Epochs iterated so far (each draws its shuffle from seed + epoch);
        # a resumed run sets it.
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size * self.batch_size
                if self.drop_remainder else n)
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            images, ids, lengths = zip(*(self.dataset[i] for i in idx))
            batch = (np.stack(images), np.stack(ids),
                     np.asarray(lengths, np.int32))
            if self.with_image_ids:
                batch = batch + (self.dataset.item_image_ids[idx],)
            yield batch


def prepare_flickr8k_dataloaders(batch_size: int = 32, image_size: int = 224,
                                 max_length: int = 50,
                                 tokenize_captions: bool = True,
                                 num_workers: int = 2,
                                 root_dir: str = "./data/flickr8k",
                                 synthetic_images: int = 400,
                                 vocab_file: Optional[str] = None,
                                 raw_uint8: bool = False,
                                 with_image_ids: bool = False):
    """``(train, val, test, vocab_size, word_to_idx)``. The train loader
    shuffles and drops the last partial batch; ``vocab_file`` forces a
    recorded vocabulary; ``num_workers`` is accepted and unused (loading is
    in-process)."""
    del num_workers
    forced = (load_vocab_file(vocab_file)
              if vocab_file and tokenize_captions else None)
    common = dict(tokenize_captions=tokenize_captions,
                  synthetic_images=synthetic_images, raw_uint8=raw_uint8)
    train_ds = Flickr8kDataset(root_dir, "train", image_size, max_length,
                               train_transform=True, vocab=forced, **common)
    vocab = train_ds.word_to_idx if tokenize_captions else None
    val_ds = Flickr8kDataset(root_dir, "val", image_size, max_length,
                             vocab=vocab, **common)
    test_ds = Flickr8kDataset(root_dir, "test", image_size, max_length,
                              vocab=vocab, **common)
    train_loader = Flickr8kLoader(train_ds, batch_size, shuffle=True,
                                  drop_remainder=True,
                                  with_image_ids=with_image_ids)
    val_loader = Flickr8kLoader(val_ds, batch_size)
    test_loader = Flickr8kLoader(test_ds, batch_size)
    if tokenize_captions:
        return (train_loader, val_loader, test_loader, train_ds.vocab_size,
                train_ds.word_to_idx)
    return train_loader, val_loader, test_loader, None, None
