"""Retrieval metrics, Recall@K in both directions (port of
atq_tpu/train/retrieval_metrics.py; numpy only).

Each (image, caption) pair is its own identity (the diagonal is the
positive), and a rank counts the scores at least the target's after the
target itself is lowered by 1e-6. The image gallery holds one row per pair,
so an image's 5 identical rows tie and the text-to-image R@1 is always 0;
:func:`compute_retrieval_metrics_dedup` adds the unique-gallery recalls
beside it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def compute_retrieval_metrics(similarity: np.ndarray,
                              topk: List[int] = (1, 5, 10)) -> Dict:
    similarity = np.asarray(similarity)
    n_images, n_texts = similarity.shape
    metrics: Dict[str, float] = {}
    n = min(n_images, n_texts)
    diag = np.diagonal(similarity)[:n]
    rows = np.arange(n)

    sim_rows = similarity[:n].copy()
    sim_rows[rows, rows] -= 1e-6
    i2t_ranks = np.sum(sim_rows >= diag[:, None], axis=1)

    sim_cols = similarity[:, :n].T.copy()
    sim_cols[rows, rows] -= 1e-6
    t2i_ranks = np.sum(sim_cols >= diag[:, None], axis=1)

    for k in topk:
        i2t = 100.0 * np.mean(i2t_ranks <= k) if n else 0.0
        t2i = 100.0 * np.mean(t2i_ranks <= k) if n else 0.0
        metrics[f"image_to_text_R@{k}"] = float(i2t)
        metrics[f"text_to_image_R@{k}"] = float(t2i)
        metrics[f"mean_R@{k}"] = float((i2t + t2i) / 2)
    return metrics


def compute_retrieval_metrics_dedup(all_img: np.ndarray,
                                    all_txt: np.ndarray,
                                    topk: List[int] = (1, 5, 10)) -> Dict:
    """Text-to-image Recall@K over the unique image rows (exact row
    equality): a text's rank is 1 + the number of unique images scoring
    more than 1e-6 above its own."""
    all_img = np.asarray(all_img)
    all_txt = np.asarray(all_txt)
    uniq, owner = np.unique(all_img, axis=0, return_inverse=True)
    owner = owner.reshape(-1)
    sims = all_txt @ uniq.T
    n = min(all_img.shape[0], all_txt.shape[0])
    target = sims[np.arange(n), owner[:n]]
    ranks = 1 + np.sum(sims[:n] > target[:, None] + 1e-6, axis=1)
    return {
        f"text_to_image_R@{k}_dedup":
            float(100.0 * np.mean(ranks <= k)) if n else 0.0
        for k in topk
    }
