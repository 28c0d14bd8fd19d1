"""MNIST / Fashion-MNIST input pipeline (numpy, host-side).

Port of atq_tpu/data/mnist.py, numpy only: the whole dataset lives in host
memory as one uint8 array, the train set is split 80/20 into train and
validation, and ``ArrayLoader`` yields batches. Every numpy RNG call is made
in the JAX package's order, so the same seed gives the same batches.

Data sourcing, in order:
1. local IDX files (torchvision layout ``<dir>/<Name>/raw/*-ubyte[.gz]`` or
   flat in ``<dir>``);
2. a download from the canonical mirrors, unless ``ATQ_NO_DOWNLOAD=1``;
3. the deterministic synthetic stand-in (class-conditional patterns).

For the trainer's device-side pipeline the train loader yields raw uint8
batches (``raw=True``): normalization and augmentation then run on the card
(data/augment.py).
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

MNIST_STATS = (0.1307, 0.3081)
FASHION_STATS = (0.2860, 0.3530)

_MIRRORS = {
    "mnist": "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "fashion_mnist":
        "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/",
}
_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}
_SUBDIR = {"mnist": "MNIST", "fashion_mnist": "FashionMNIST"}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find_file(data_dir: str, dataset: str, fname: str):
    base = fname[:-3]  # without .gz
    candidates = [
        os.path.join(data_dir, _SUBDIR[dataset], "raw", base),
        os.path.join(data_dir, _SUBDIR[dataset], "raw", fname),
        os.path.join(data_dir, dataset, base),
        os.path.join(data_dir, dataset, fname),
        os.path.join(data_dir, base),
        os.path.join(data_dir, fname),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def _try_download(data_dir: str, dataset: str) -> bool:
    if os.environ.get("ATQ_NO_DOWNLOAD", "0") == "1":
        return False
    import urllib.request

    target_dir = os.path.join(data_dir, _SUBDIR[dataset], "raw")
    os.makedirs(target_dir, exist_ok=True)
    try:
        for fname in _FILES.values():
            dest = os.path.join(target_dir, fname)
            if not os.path.exists(dest):
                urllib.request.urlretrieve(_MIRRORS[dataset] + fname, dest)
        return True
    except OSError:  # no route, refused, HTTP error: the next source
        return False


def _templates(dataset: str) -> np.ndarray:
    """Each class's low-frequency template, (10, 28, 28) float32."""
    rng = np.random.RandomState(0 if dataset == "mnist" else 1)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 28.0
    templates = []
    for _ in range(10):
        fx, fy = rng.uniform(1, 4, 2)
        px, py = rng.uniform(0, np.pi, 2)
        templates.append(0.5 + 0.5 * np.sin(2 * np.pi * fx * xx + px)
                         * np.cos(2 * np.pi * fy * yy + py))
    return np.stack(templates)


def _make(templates: np.ndarray, n: int, seed: int):
    r = np.random.RandomState(seed)
    labels = r.randint(0, 10, n).astype(np.int64)
    imgs = templates[labels]
    imgs = imgs + r.randn(n, 28, 28).astype(np.float32) * 0.25
    imgs = np.clip(imgs, 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def _synthetic(dataset: str, n_train: int = 60000, n_test: int = 10000):
    """Deterministic class-conditional patterns: each class is a distinct
    low-frequency template plus pixel noise (learnable but not trivial).
    Returns train images, train labels, test images, test labels."""
    templates = _templates(dataset)
    tr = _make(templates, n_train, 100)
    te = _make(templates, n_test, 200)
    return tr[0], tr[1], te[0], te[1]


def synthetic_test_set(dataset: str = "fashion_mnist", n: int = 10000):
    """The synthetic stand-in's test split: ``(images (n, 28, 28) uint8,
    labels (n,) int64)``, equal to the last two arrays of
    ``_synthetic(dataset, n_test=n)``."""
    return _make(_templates(dataset), n, 200)


def _load_arrays(dataset: str, data_dir: str):
    paths = {k: _find_file(data_dir, dataset, v) for k, v in _FILES.items()}
    if not all(paths.values()) and _try_download(data_dir, dataset):
        paths = {k: _find_file(data_dir, dataset, v)
                 for k, v in _FILES.items()}
    if all(paths.values()):
        return (
            _read_idx(paths["train_images"]),
            _read_idx(paths["train_labels"]).astype(np.int64),
            _read_idx(paths["test_images"]),
            _read_idx(paths["test_labels"]).astype(np.int64),
            False,
        )
    imgs, labels, timgs, tlabels = _synthetic(dataset)
    print(f"[atq_tpu_torch.data] {dataset}: no local data and no download "
          "-> using the deterministic synthetic stand-in")
    return imgs, labels, timgs, tlabels, True


def _rotate_batch(images: np.ndarray, angles_deg: np.ndarray) -> np.ndarray:
    """Bilinear rotation of each image about its center, zero fill (the
    host-side analog of torchvision RandomRotation)."""
    n, h, w = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = np.deg2rad(angles_deg).astype(np.float32)
    cos, sin = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy = yy - cy
    xx = xx - cx
    src_x = cos[:, None, None] * xx + sin[:, None, None] * yy + cx
    src_y = -sin[:, None, None] * xx + cos[:, None, None] * yy + cy
    x0 = np.floor(src_x).astype(np.int32)
    y0 = np.floor(src_y).astype(np.int32)
    fx = src_x - x0
    fy = src_y - y0
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    idx = np.arange(n)[:, None, None]
    img = images.astype(np.float32)
    out = (
        img[idx, y0c, x0c] * (1 - fx) * (1 - fy)
        + img[idx, y0c, x1c] * fx * (1 - fy)
        + img[idx, y1c, x0c] * (1 - fx) * fy
        + img[idx, y1c, x1c] * fx * fy
    )
    oob = (src_x < 0) | (src_x > w - 1) | (src_y < 0) | (src_y > h - 1)
    out[oob] = 0.0
    return out


@dataclass
class ArrayLoader:
    """Epoch iterator over in-memory arrays, with optional host-side
    augmentation; ``raw=True`` yields uint8 NHWC batches for the device
    pipeline instead of normalized float32 ones."""

    images: np.ndarray  # (N, 28, 28) uint8
    labels: np.ndarray  # (N,)
    batch_size: int
    stats: Tuple[float, float]
    shuffle: bool = False
    augment: bool = False
    flip: bool = False
    seed: int = 0
    drop_remainder: bool = False
    raw: bool = False

    def __post_init__(self):
        self._epoch = 0

    def __len__(self):
        n = len(self.images)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.images)
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        mean, std = self.stats
        stop = (n // self.batch_size * self.batch_size
                if self.drop_remainder else n)
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.raw:
                yield (self.images[idx][..., None],
                       self.labels[idx].astype(np.int32))
                continue
            batch = self.images[idx].astype(np.float32)
            if self.augment:
                angles = rng.uniform(-5, 5, len(idx))
                batch = _rotate_batch(batch, angles)
                if self.flip:
                    flips = rng.rand(len(idx)) < 0.5
                    batch[flips] = batch[flips, :, ::-1]
            batch = batch / 255.0
            batch = (batch - mean) / std
            yield batch[..., None], self.labels[idx].astype(np.int32)


def _make_loaders(dataset: str, batch_size: int, data_dir: str,
                  subset_fraction: float, flip: bool,
                  stats: Tuple[float, float], seed: int = 0):
    train_imgs, train_labels, test_imgs, test_labels, _synth = _load_arrays(
        dataset, data_dir
    )
    rng = np.random.RandomState(seed)
    if subset_fraction < 1.0:
        k = int(len(train_imgs) * subset_fraction)
        sel = rng.permutation(len(train_imgs))[:k]
        train_imgs, train_labels = train_imgs[sel], train_labels[sel]
        kt = int(len(test_imgs) * subset_fraction)
        selt = rng.permutation(len(test_imgs))[:kt]
        test_imgs, test_labels = test_imgs[selt], test_labels[selt]

    # 80/20 train/val split.
    n_train = int(0.8 * len(train_imgs))
    perm = rng.permutation(len(train_imgs))
    tr, va = perm[:n_train], perm[n_train:]

    train_loader = ArrayLoader(train_imgs[tr], train_labels[tr], batch_size,
                               stats, shuffle=True, augment=True, flip=flip,
                               seed=seed, drop_remainder=True)
    val_loader = ArrayLoader(train_imgs[va], train_labels[va], batch_size,
                             stats)
    test_loader = ArrayLoader(test_imgs, test_labels, batch_size, stats)
    return train_loader, val_loader, test_loader


def get_mnist_data(batch_size: int = 128, data_dir: str = "./data",
                   subset_fraction: float = 0.2):
    return _make_loaders("mnist", batch_size, data_dir, subset_fraction,
                         flip=False, stats=MNIST_STATS)


def get_fashion_mnist_data(batch_size: int = 128, data_dir: str = "./data",
                           subset_fraction: float = 0.2):
    return _make_loaders("fashion_mnist", batch_size, data_dir,
                         subset_fraction, flip=True, stats=FASHION_STATS)
