"""Hybrid ELL+COO form of a sparse correction matrix (numpy, host-side).

A copy of the vectorized numpy branch of atq_tpu/native/__init__.py:
sparse_ell. The ctypes binding to csrc/atq_native.cpp waits for a later
slice (ROADMAP.md); both produce the same arrays.
"""

from __future__ import annotations

import numpy as np


def sparse_ell(correction: np.ndarray, c: int):
    """Hybrid ELL+COO arrays for a sparse correction matrix.

    Returns ``(idx (n,c) int32, val (n,c) f32, coo_row, coo_col, coo_val)``:
    the first ``c`` nonzeros of each row in column order in the ELL part
    (padding points at column 0 with value 0), the rest in the COO triple.
    """
    correction = np.ascontiguousarray(correction, dtype=np.float32)
    n, _ = correction.shape
    nnz_per_row = np.count_nonzero(correction, axis=1)
    idx = np.zeros((n, c), np.int32)
    val = np.zeros((n, c), np.float32)
    rows, cols = np.nonzero(correction)  # row-major order
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(nnz_per_row, out=starts[1:])
    pos = np.arange(rows.size) - starts[rows]  # position within its row
    ell = pos < c
    idx[rows[ell], pos[ell]] = cols[ell]
    val[rows[ell], pos[ell]] = correction[rows[ell], cols[ell]]
    sp = ~ell
    return (idx, val, rows[sp].astype(np.int32),
            cols[sp].astype(np.int32),
            correction[rows[sp], cols[sp]].astype(np.float32))
