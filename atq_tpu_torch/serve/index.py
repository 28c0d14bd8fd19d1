"""Device-resident embedding index for corpus-side retrieval serving.

Port of atq_tpu/serve/index.py on one device:

- the host keeps a float32 master of the corpus (adds and saves are exact)
  in a power-of-two capacity tier; the device copy is committed lazily at
  the next search after an add;
- a search scores ``queries @ corpusᵀ`` on the device, masks the empty
  tail slots to -inf and takes ``torch.topk``;
- ``quantize="int8"`` holds the device corpus as per-row symmetric int8
  (``scale = max|row| / 127``) and scores bf16-rounded queries against it
  with float32 accumulation (the product of a bf16 value and an int8 value
  is exact in float32), times the row scales.

Embeddings from the retrieval model are L2-normalized, so the dot product
is the cosine score. The row-sharded multi-device search
(``_sharded_search_fn``) waits for slice H.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from atq_tpu_torch.utils.platform import resolve_device


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class EmbeddingIndex:
    """In-memory embedding index with device-side top-k search.

    Thread-safe for the serving pattern (HTTP handler threads calling
    ``add``/``search`` concurrently): the host buffers and the device
    commit change under one lock.
    """

    def __init__(self, dim: int, capacity: int = 1024,
                 quantize: str = "none", device=None):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', "
                             f"got {quantize!r}")
        self.dim = int(dim)
        self.quantize = quantize
        self.device = resolve_device(device)
        self._capacity = _next_pow2(max(1, capacity))
        self._embs = np.zeros((self._capacity, self.dim), np.float32)
        if quantize == "int8":  # filled at add() time, row by row
            self._q8 = np.zeros((self._capacity, self.dim), np.int8)
            self._scales = np.zeros((self._capacity,), np.float32)
        self._ids: List[str] = []
        self._device_corpus = None  # committed tensors, None = dirty
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        return self._capacity

    def add(self, ids: Sequence[str], embeddings: np.ndarray,
            normalize: bool = False) -> int:
        """Append ``len(ids)`` rows; returns the new item count.
        ``embeddings``: ``(n, dim)`` (or ``(dim,)`` with a single id)."""
        embs = np.asarray(embeddings, np.float32)
        if embs.ndim == 1:
            embs = embs[None, :]
        if isinstance(ids, str):
            ids = [ids]
        ids = [str(i) for i in ids]
        if embs.shape != (len(ids), self.dim):
            raise ValueError(f"expected ({len(ids)}, {self.dim}) "
                             f"embeddings, got {embs.shape}")
        if normalize:
            norms = np.linalg.norm(embs, axis=1, keepdims=True)
            embs = embs / np.maximum(norms, 1e-12)
        with self._lock:
            n0, n1 = len(self._ids), len(self._ids) + len(ids)
            if n1 > self._capacity:
                new_cap = _next_pow2(n1)
                self._embs = self._grow(self._embs, new_cap)
                if self.quantize == "int8":
                    self._q8 = self._grow(self._q8, new_cap)
                    self._scales = self._grow(self._scales, new_cap)
                self._capacity = new_cap
            self._embs[n0:n1] = embs
            if self.quantize == "int8":
                self._q8[n0:n1], self._scales[n0:n1] = \
                    self._quantize_rows(embs)
            self._ids.extend(ids)
            self._device_corpus = None
            return n1

    @staticmethod
    def _grow(a: np.ndarray, capacity: int) -> np.ndarray:
        grown = np.zeros((capacity,) + a.shape[1:], a.dtype)
        grown[:a.shape[0]] = a
        return grown

    @staticmethod
    def _quantize_rows(embs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row symmetric int8: ``row ~= q * scale``."""
        scales = np.max(np.abs(embs), axis=1) / 127.0
        safe = np.maximum(scales, 1e-12)
        q = np.clip(np.rint(embs / safe[:, None]), -127, 127)
        return q.astype(np.int8), scales.astype(np.float32)

    def _corpus(self):
        """The device corpus, committed if an add made it stale."""
        if self._device_corpus is None:
            if self.quantize == "int8":
                self._device_corpus = (
                    torch.from_numpy(self._q8).to(self.device),
                    torch.from_numpy(self._scales).to(self.device))
            else:
                self._device_corpus = torch.from_numpy(
                    self._embs.copy()).to(self.device)
        return self._device_corpus

    def _scores(self, corpus, q: torch.Tensor) -> torch.Tensor:
        if self.quantize == "int8":
            c8, scales = corpus
            q16 = q.to(torch.bfloat16).float()
            return torch.matmul(q16, c8.float().T) * scales[None, :]
        return torch.matmul(q, corpus.T)

    def search(self, queries: np.ndarray, k: int = 5,
               normalize: bool = False
               ) -> Tuple[List[List[str]], np.ndarray]:
        """Top-``k`` corpus items per query by dot-product score.

        ``queries``: ``(B, dim)`` or ``(dim,)``. Returns ``(ids, scores)``:
        ids as a list of per-query lists, scores ``(B, k_eff)`` with
        ``k_eff = min(k, len(self))``; a 1-D query gives one list and a
        1-D score row."""
        q = np.asarray(queries, np.float32)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (B, {self.dim}), "
                             f"got {q.shape}")
        if normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-12)
        with self._lock:
            n = len(self._ids)
            if n == 0:
                raise ValueError("index is empty")
            ids = list(self._ids)
            corpus = self._corpus()
        k_eff = max(1, min(int(k), n))
        scores = self._scores(corpus, torch.from_numpy(q).to(self.device))
        slot = torch.arange(scores.shape[1], device=self.device)[None, :]
        scores = scores.masked_fill(slot >= n, float("-inf"))
        top, idx = torch.topk(scores, k_eff, dim=1)
        top, idx = top.cpu().numpy(), idx.cpu().numpy()
        out_ids = [[ids[j] for j in row] for row in idx]
        if squeeze:
            return out_ids[0], top[0]
        return out_ids, top

    def save(self, path: str) -> None:
        with self._lock:
            n = len(self._ids)
            np.savez_compressed(path, ids=np.asarray(self._ids, object),
                                embeddings=self._embs[:n])

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None,
             quantize: str = "none", device=None) -> "EmbeddingIndex":
        """An index from :meth:`save`'s file (the JAX package's format).
        The ids are stored as an object array, so the file is unpickled:
        load only files this program wrote."""
        with np.load(path, allow_pickle=True) as data:
            embs = np.asarray(data["embeddings"], np.float32)
            ids = [str(i) for i in data["ids"]]
        idx = cls(dim=embs.shape[1] if embs.size else 1,
                  capacity=capacity or max(1, len(ids)),
                  quantize=quantize, device=device)
        if ids:
            idx.add(ids, embs)
        return idx
