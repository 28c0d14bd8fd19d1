"""Matmul directly from 2-bit packed ternary planes.

PyTorch counterpart of atq_tpu/ops/ternary_matmul.py. The JAX package's
``_kernel`` and ``_kernel_kblocked`` Pallas kernels both become the one
CUDA kernel in ``csrc/ternary_matmul.cu``, whose loop over K covers the
K-blocked case. ``ternary_matmul_planar`` is that kernel's wrapper: on a
CUDA tensor it launches the kernel (or raises), on a CPU tensor it takes
the plain PyTorch version (unpack, then matmul).

``packed_ternary_matmul`` keeps the JAX entry point's rule: shapes with
K >= 128 and N >= 8 go to the kernel wrapper, smaller ones through
``unpack_planar`` and ``torch.matmul``, as JAX sends them to XLA.
"""

from __future__ import annotations

import torch

from atq_tpu_torch.core.packing import unpack_planar
from atq_tpu_torch.ops._build import check, load_library

_K_ALIGN = 512  # pack_planar's K padding


def kernel_eligible(x_shape, w_shape) -> bool:
    """The JAX package's eligibility rule (pallas_eligible without the
    platform test): non-trivial shapes go to the kernel."""
    (m, k) = x_shape
    (n, k2) = w_shape
    return k == k2 and k >= 128 and n >= 8 and m >= 1


def _scaled_matmul(x, w, alpha, alpha_neg):
    """Matmul over a decoded ±1/0 plane, symmetric or TTQ."""
    if alpha_neg is None:
        return torch.matmul(x, w.T) * alpha
    w_eff = alpha * torch.clamp(w, min=0) + alpha_neg * torch.clamp(w, max=0)
    return torch.matmul(x, w_eff.T)


def ternary_matmul_plain(x, planes, k: int, alpha_vec, asym: bool):
    """Plain PyTorch version of the kernel: unpack, then matmul."""
    w = unpack_planar(planes, k, dtype=x.dtype)
    return _scaled_matmul(x, w, alpha_vec[0],
                          alpha_vec[1] if asym else None)


def _check_inputs(x, planes, k, alpha_vec):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    kq = (k + (-k) % _K_ALIGN) // 4
    if planes.dtype != torch.uint8 or planes.ndim != 2 \
            or planes.shape[1] != kq:
        raise ValueError(f"planes must be (N, {kq}) uint8 for K={k}, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if alpha_vec.dtype != torch.float32 or alpha_vec.numel() != 2:
        raise ValueError("alpha_vec must hold 2 float32 values")
    for name, t in (("x", x), ("planes", planes), ("alpha_vec", alpha_vec)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ternary_matmul_planar(x: torch.Tensor, planes: torch.Tensor, k: int,
                          alpha_vec: torch.Tensor,
                          asym: bool = False) -> torch.Tensor:
    """``x @ decode(planes)ᵀ · alpha`` (symmetric) or with TTQ scales.

    ``x`` (M, K) float32; ``planes`` (N, K_pad/4) uint8 from
    ``pack_planar``; ``alpha_vec`` float32 ``[alpha, alpha]`` or
    ``[alpha_p, alpha_n]`` with ``asym=True``. Returns (M, N) float32.
    """
    _check_inputs(x, planes, k, alpha_vec)
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, planes, k, alpha_vec, asym)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = load_library()
    m, n = x.shape[0], planes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    check(lib.atq_ternary_matmul(
        x.device.index if x.device.index is not None else 0,
        x.data_ptr(), planes.data_ptr(), alpha_vec.data_ptr(),
        out.data_ptr(), m, n, k, planes.shape[1], int(asym),
        torch.cuda.current_stream(x.device).cuda_stream),
        "ternary_matmul kernel")
    ternary_matmul_planar.launches += 1
    return out


ternary_matmul_planar.launches = 0


def _alpha_vec(alpha, alpha_neg, device) -> torch.Tensor:
    """Device scale vector: [alpha, alpha] symmetric, [alpha_p, alpha_n]
    TTQ."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device).reshape(())
    b = a if alpha_neg is None else torch.as_tensor(
        alpha_neg, dtype=torch.float32, device=device).reshape(())
    return torch.stack([a, b])


def packed_ternary_matmul(x: torch.Tensor, w_packed: torch.Tensor, w_shape,
                          alpha=1.0, layout: str = "planar", alpha_neg=None):
    """``x @ unpack(W)ᵀ · alpha`` from planar 2-bit planes.

    Args:
        x: (M, K) activations.
        w_packed: (N, K_pad/4) uint8 planes from ``pack_planar``.
        w_shape: (N, K) logical weight shape.
        alpha: scalar scale (the TTQ positive scale with ``alpha_neg``).
        layout: only ``'planar'``; the ``rows``, ``flat`` and ``planar32``
            layouts come with the serving slice (ROADMAP.md).
        alpha_neg: optional TTQ negative scale: computes
            ``x @ (alpha·[w=+1] − alpha_neg·[w=−1])ᵀ`` from the same planes.
    """
    if layout != "planar":
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet (serving slice, "
            f"ROADMAP.md queue 1); use layout='planar'")
    n, k = w_shape
    if kernel_eligible((x.shape[0], k), (n, k)):
        avec = _alpha_vec(alpha, alpha_neg, x.device)
        return ternary_matmul_planar(x.float().contiguous(), w_packed, k,
                                     avec, asym=alpha_neg is not None
                                     ).to(x.dtype)
    w = unpack_planar(w_packed, k, dtype=x.dtype)
    return _scaled_matmul(x, w, alpha, alpha_neg)
