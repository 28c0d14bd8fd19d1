"""MNIST / Fashion-MNIST normalization stats and the seeded synthetic test
set (numpy, host-side).

Port of the parts of atq_tpu/data/mnist.py that serving needs: the
train-time (mean, std) per dataset and the deterministic class-conditional
synthetic stand-in, which gives the same arrays from the same seed as the
JAX package. The IDX loaders, augmentation and train/val split come with
the training slice.
"""

from __future__ import annotations

import numpy as np

MNIST_STATS = (0.1307, 0.3081)
FASHION_STATS = (0.2860, 0.3530)


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


def synthetic_test_set(dataset: str = "fashion_mnist", n: int = 10000):
    """The synthetic stand-in's test split: ``(images (n, 28, 28) uint8,
    labels (n,) int64)``, equal to the last two arrays of
    ``atq_tpu.data.mnist._synthetic(dataset, n_test=n)``."""
    return _make(_templates(dataset), n, 200)
