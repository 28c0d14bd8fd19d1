"""ctypes binding to the host-side kernels of ``csrc/atq_native.cpp``.

Port of atq_tpu/native/__init__.py: ``pack_ternary``, ``unpack_ternary``,
``pack_planar``, ``ternarize`` and ``sparse_ell`` on numpy arrays, for the
host-side paths (checkpoint export, serving-weight preparation). The
library is built with ``c++`` at first use, from the repository's
``csrc/atq_native.cpp``, into ``atq_tpu_torch/_build/`` (listed in
.gitignore); its name carries a hash of the source and the flags, so an
edited source rebuilds. A failed build raises: unlike the JAX package,
nothing falls back to numpy in silence. The numpy versions stay beside the
binding as the ``*_plain`` functions, which the tests hold it against.

Encoding (the reference's): -1 -> 00, 0 -> 01, +1 -> 10, four values a
byte, value i in bits 2·(i % 4) of byte i / 4.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "csrc" / "atq_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]  # no -ffast-math

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.atq_pack_ternary.restype = ctypes.c_int
    lib.atq_pack_ternary.argtypes = [f32p, u8p, i64]
    lib.atq_unpack_ternary.restype = None
    lib.atq_unpack_ternary.argtypes = [u8p, f32p, i64]
    lib.atq_pack_planar.restype = ctypes.c_int
    lib.atq_pack_planar.argtypes = [f32p, u8p, i64, i64, i64]
    lib.atq_ternarize.restype = i64
    lib.atq_ternarize.argtypes = [f32p, f32p, i64, ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.atq_sparse_ell.restype = i64
    lib.atq_sparse_ell.argtypes = [f32p, i64, i64, i64, i32p, f32p, i32p,
                                   i32p, f32p]
    return lib


def _build(target: pathlib.Path) -> None:
    cxx = os.environ.get("CXX", "c++")
    tmp = target.with_name(f"{target.stem}-{os.getpid()}-"
                           f"{threading.get_ident()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)  # atomic: readers never see a partial file


def load_library() -> ctypes.CDLL:
    """The native library, built from ``csrc/atq_native.cpp`` on first
    call."""
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                                    + SOURCE.read_bytes()).hexdigest()[:16]
            target = BUILD_DIR / f"libatq_native-{digest}.so"
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _build(target)
            _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _not_ternary():
    return ValueError("Input must contain only ternary values (-1, 0, 1)")


# ---------------------------------------------------------------------------
# The binding.
# ---------------------------------------------------------------------------

def pack_ternary(values: np.ndarray) -> np.ndarray:
    """Flat reference-format 2-bit packing of a float32 ternary array:
    ``ceil(n / 4)`` bytes, the last byte's unused fields 0 (they decode as
    -1). Raises on a value other than -1, 0, +1."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    out = np.empty((flat.size + 3) // 4, dtype=np.uint8)
    if load_library().atq_pack_ternary(_ptr(flat, ctypes.c_float),
                                       _ptr(out, ctypes.c_uint8), flat.size):
        raise _not_ternary()
    return out


def unpack_ternary(packed: np.ndarray, n: int, shape=None) -> np.ndarray:
    """Inverse of :func:`pack_ternary`: the first ``n`` values as float32,
    reshaped to ``shape`` when given."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.size * 4 < n:
        raise ValueError(f"{packed.size} bytes hold fewer than {n} values")
    out = np.empty(n, dtype=np.float32)
    load_library().atq_unpack_ternary(_ptr(packed, ctypes.c_uint8),
                                      _ptr(out, ctypes.c_float), n)
    return out.reshape(shape) if shape is not None else out


def pack_planar(values: np.ndarray, k_align: int = 512) -> np.ndarray:
    """Planar packing (the kernels' layout, core/packing.py
    ``pack_planar``) of a 2-D float32 ternary matrix: (N, K_pad / 4)
    uint8. Raises on a value other than -1, 0, +1."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    rows, cols = values.shape
    k_padded = cols + ((-cols) % k_align)
    out = np.empty((rows, k_padded // 4), dtype=np.uint8)
    if load_library().atq_pack_planar(_ptr(values, ctypes.c_float),
                                      _ptr(out, ctypes.c_uint8), rows, cols,
                                      k_padded):
        raise _not_ternary()
    return out


def ternarize(weights: np.ndarray, threshold: float):
    """Threshold-ternarize on the host: ``(w_t, nnz, dot)`` with ``dot =
    sum(w · w_t)`` (summed in float64, in index order) for the optimal
    alpha."""
    flat = np.ascontiguousarray(weights, dtype=np.float32).reshape(-1)
    out = np.empty_like(flat)
    acc = ctypes.c_double(0.0)
    nnz = int(load_library().atq_ternarize(
        _ptr(flat, ctypes.c_float), _ptr(out, ctypes.c_float), flat.size,
        ctypes.c_float(threshold), ctypes.byref(acc)))
    return out.reshape(np.shape(weights)), nnz, acc.value


def _ell_shapes(correction: np.ndarray, c: int):
    correction = np.ascontiguousarray(correction, dtype=np.float32)
    n = correction.shape[0]
    spill = int(np.maximum(np.count_nonzero(correction, axis=1) - c,
                           0).sum())
    return (correction, np.zeros((n, c), np.int32),
            np.zeros((n, c), np.float32), spill)


def sparse_ell(correction: np.ndarray, c: int):
    """Hybrid ELL+COO arrays of a sparse correction matrix.

    Returns ``(idx (n, c) int32, val (n, c) f32, coo_row, coo_col,
    coo_val)``: the first ``c`` nonzeros of each row in column order in
    the ELL part (padding points at column 0 with value 0), the rest in
    the COO triple, in row-major order. One pass over the matrix."""
    correction, idx, val, spill = _ell_shapes(correction, c)
    n, k = correction.shape
    coo_row = np.empty(spill, np.int32)
    coo_col = np.empty(spill, np.int32)
    coo_val = np.empty(spill, np.float32)
    wrote = int(load_library().atq_sparse_ell(
        _ptr(correction, ctypes.c_float), n, k, c,
        _ptr(idx, ctypes.c_int32), _ptr(val, ctypes.c_float),
        _ptr(coo_row, ctypes.c_int32), _ptr(coo_col, ctypes.c_int32),
        _ptr(coo_val, ctypes.c_float)))
    if wrote != spill:
        raise RuntimeError(f"atq_sparse_ell wrote {wrote} COO entries, "
                           f"expected {spill}")
    return idx, val, coo_row, coo_col, coo_val


# ---------------------------------------------------------------------------
# Plain numpy versions (the tests' yardstick).
# ---------------------------------------------------------------------------

def _codes(flat: np.ndarray) -> np.ndarray:
    if not np.isin(flat, (-1.0, 0.0, 1.0)).all():
        raise _not_ternary()
    return (flat + 1).astype(np.uint8)


def pack_ternary_plain(values: np.ndarray) -> np.ndarray:
    """numpy version of :func:`pack_ternary`."""
    mapped = _codes(np.asarray(values, np.float32).reshape(-1))
    mapped = np.concatenate([mapped, np.zeros((-mapped.size) % 4, np.uint8)])
    q = mapped.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def unpack_ternary_plain(packed: np.ndarray, n: int,
                         shape=None) -> np.ndarray:
    """numpy version of :func:`unpack_ternary`."""
    packed = np.asarray(packed, np.uint8).reshape(-1)
    vals = (packed[:, None] >> np.asarray([0, 2, 4, 6], np.uint8)) & 0x3
    lut = np.asarray([-1.0, 0.0, 1.0, 0.0], np.float32)
    out = lut[vals.reshape(-1)[:n]]
    return out.reshape(shape) if shape is not None else out


def pack_planar_plain(values: np.ndarray, k_align: int = 512) -> np.ndarray:
    """numpy version of :func:`pack_planar`."""
    values = np.asarray(values, np.float32)
    rows, cols = values.shape
    codes = _codes(values.reshape(-1)).reshape(rows, cols)
    codes = np.pad(codes, ((0, 0), (0, (-cols) % k_align)),
                   constant_values=1)  # padding encodes 0
    q = codes.reshape(rows, 4, -1)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def ternarize_plain(weights: np.ndarray, threshold: float):
    """numpy version of :func:`ternarize` (``dot`` summed in float64 in
    index order, as the C loop sums it)."""
    w = np.asarray(weights, np.float32)
    thr = np.float32(threshold)
    out = np.where(w > thr, 1.0, np.where(w < -thr, -1.0, 0.0)).astype(
        np.float32)
    terms = (w.astype(np.float64) * out).reshape(-1)
    dot = float(np.cumsum(terms)[-1]) if terms.size else 0.0
    return out, int(np.count_nonzero(out)), dot


def sparse_ell_plain(correction: np.ndarray, c: int):
    """numpy version of :func:`sparse_ell` (vectorized, no loop over
    rows)."""
    correction, idx, val, _ = _ell_shapes(correction, c)
    n = correction.shape[0]
    rows, cols = np.nonzero(correction)  # row-major order
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(np.count_nonzero(correction, axis=1), out=starts[1:])
    pos = np.arange(rows.size) - starts[rows]  # position within its row
    ell = pos < c
    idx[rows[ell], pos[ell]] = cols[ell]
    val[rows[ell], pos[ell]] = correction[rows[ell], cols[ell]]
    sp = ~ell
    return (idx, val, rows[sp].astype(np.int32),
            cols[sp].astype(np.int32),
            correction[rows[sp], cols[sp]].astype(np.float32))
