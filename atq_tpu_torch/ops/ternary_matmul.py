"""Matmul directly from 2-bit packed ternary planes.

PyTorch counterpart of atq_tpu/ops/ternary_matmul.py. One tiled CUDA
kernel in ``csrc/ternary_matmul.cu``, with a decoder for each layout, has
three entry points, one wrapper each:

- ``ternary_matmul_planar``: the JAX package's ``_kernel`` and
  ``_kernel_kblocked`` (uint8 ``planar`` planes); its walk over K covers
  the K-blocked case;
- ``ternary_matmul_planar32``: ``_kernel32`` (int32 ``planar32`` words, 16
  fields a word), symmetric or TTQ;
- ``ternary_matmul_rpb``: ``_kernel_rpb``, the uint8 planes plus a dense
  (N, K) bf16 RPB correction, as two f32 sums.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it takes its plain PyTorch version (unpack, then matmul). Each counts its
launches in ``.launches`` and their products' FLOPs in ``.flops``.

``packed_ternary_matmul`` and ``packed_ternary_matmul_rpb`` keep the JAX
entry points' rule: shapes with K >= 128 and N >= 8 go to a kernel wrapper,
smaller ones through the unpack and ``torch.matmul``, as JAX sends them to
XLA. JAX has no K-blocked planar32 kernel and decodes through XLA where
``tile_m·K_pad·4`` passes 4 MiB; the port's kernel runs at any K, with the
same result.
"""

from __future__ import annotations

import torch

from atq_tpu_torch.core.packing import unpack_planar, unpack_planar32
from atq_tpu_torch.ops import matmul_flops
from atq_tpu_torch.ops._build import check, load_library

_K_ALIGN = 512  # pack_planar's K padding
_K_ALIGN32 = 2048  # pack_planar32's K padding


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


def ternary_matmul32_plain(x, planes, k: int, alpha_vec, asym: bool):
    """Plain PyTorch version of the planar32 kernel: unpack, then matmul."""
    w = unpack_planar32(planes, k, dtype=x.dtype)
    return _scaled_matmul(x, w, alpha_vec[0],
                          alpha_vec[1] if asym else None)


def ternary_matmul_rpb_plain(x, planes, correction, k: int, alpha_vec):
    """Plain PyTorch version of the RPB kernel: the ternary product scaled
    by alpha, then the correction's product added (two sums, as the
    kernel keeps them)."""
    w = unpack_planar(planes, k, dtype=x.dtype)
    return (torch.matmul(x, w.T) * alpha_vec[0]
            + torch.matmul(x, correction.to(x.dtype).T))


def _check_inputs(x, planes, k, alpha_vec, dtype=torch.uint8,
                  k_align=_K_ALIGN, per_word=4, correction=None):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    kw = (k + (-k) % k_align) // per_word
    if planes.dtype != dtype or planes.ndim != 2 or planes.shape[1] != kw:
        raise ValueError(f"planes must be (N, {kw}) {dtype} for K={k}, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if alpha_vec.dtype != torch.float32 or alpha_vec.numel() != 2:
        raise ValueError("alpha_vec must hold 2 float32 values")
    tensors = [("x", x), ("planes", planes), ("alpha_vec", alpha_vec)]
    if correction is not None:
        if correction.dtype != torch.bfloat16 \
                or tuple(correction.shape) != (planes.shape[0], k):
            raise ValueError(f"correction must be ({planes.shape[0]}, {k}) "
                             f"bfloat16, got {correction.dtype} "
                             f"{tuple(correction.shape)}")
        tensors.append(("correction", correction))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device_index(x) -> int:
    return x.device.index if x.device.index is not None else 0


def _workspace(lib, m, n, k, device):
    """The kernel's split-K partials' workspace (an empty tensor when K is
    not split)."""
    floats = lib.atq_packed_workspace_floats(m, n, k)
    return torch.empty((floats,), dtype=torch.float32, device=device)


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
    ws = _workspace(lib, m, n, k, x.device)
    check(lib.atq_ternary_matmul(
        _device_index(x), x.data_ptr(), planes.data_ptr(),
        alpha_vec.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, k,
        planes.shape[1], int(asym),
        torch.cuda.current_stream(x.device).cuda_stream),
        "ternary_matmul kernel")
    ternary_matmul_planar.launches += 1
    ternary_matmul_planar.flops += matmul_flops(m, n, k)
    return out


ternary_matmul_planar.launches = 0
ternary_matmul_planar.flops = 0


def ternary_matmul_planar32(x: torch.Tensor, planes: torch.Tensor, k: int,
                            alpha_vec: torch.Tensor,
                            asym: bool = False) -> torch.Tensor:
    """``x @ decode(planes)ᵀ · alpha`` (symmetric) or with TTQ scales, from
    planar32 words.

    ``x`` (M, K) float32; ``planes`` (N, K_pad/16) int32 from
    ``pack_planar32``; ``alpha_vec`` as for :func:`ternary_matmul_planar`.
    Returns (M, N) float32.
    """
    _check_inputs(x, planes, k, alpha_vec, dtype=torch.int32,
                  k_align=_K_ALIGN32, per_word=16)
    if x.device.type == "cpu":
        return ternary_matmul32_plain(x, planes, k, alpha_vec, asym)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = load_library()
    m, n = x.shape[0], planes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    ws = _workspace(lib, m, n, k, x.device)
    check(lib.atq_ternary_matmul32(
        _device_index(x), x.data_ptr(), planes.data_ptr(),
        alpha_vec.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, k,
        planes.shape[1], int(asym),
        torch.cuda.current_stream(x.device).cuda_stream),
        "ternary_matmul32 kernel")
    ternary_matmul_planar32.launches += 1
    ternary_matmul_planar32.flops += matmul_flops(m, n, k)
    return out


ternary_matmul_planar32.launches = 0
ternary_matmul_planar32.flops = 0


def ternary_matmul_rpb(x: torch.Tensor, planes: torch.Tensor,
                       correction: torch.Tensor, k: int,
                       alpha_vec: torch.Tensor) -> torch.Tensor:
    """``(x @ decode(planes)ᵀ) · alpha + x @ correctionᵀ``.

    ``x`` (M, K) float32; ``planes`` (N, K_pad/4) uint8 from
    ``pack_planar``; ``correction`` the unpadded (N, K) bfloat16 RPB
    correction; ``alpha_vec`` ``[alpha, alpha]``. Returns (M, N) float32.
    """
    _check_inputs(x, planes, k, alpha_vec, correction=correction)
    if x.device.type == "cpu":
        return ternary_matmul_rpb_plain(x, planes, correction, k, alpha_vec)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = load_library()
    m, n = x.shape[0], planes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    ws = _workspace(lib, m, n, k, x.device)
    check(lib.atq_ternary_matmul_rpb(
        _device_index(x), x.data_ptr(), planes.data_ptr(),
        correction.data_ptr(), alpha_vec.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, n, k, planes.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream),
        "ternary_matmul_rpb kernel")
    ternary_matmul_rpb.launches += 1
    ternary_matmul_rpb.flops += matmul_flops(m, n, k, products=2)
    return out


ternary_matmul_rpb.launches = 0
ternary_matmul_rpb.flops = 0


def _alpha_vec(alpha, alpha_neg, device) -> torch.Tensor:
    """Device scale vector: [alpha, alpha] symmetric, [alpha_p, alpha_n]
    TTQ."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device).reshape(())
    b = a if alpha_neg is None else torch.as_tensor(
        alpha_neg, dtype=torch.float32, device=device).reshape(())
    return torch.stack([a, b])


def packed_ternary_matmul(x: torch.Tensor, w_packed: torch.Tensor, w_shape,
                          alpha=1.0, layout: str = "planar", alpha_neg=None):
    """``x @ unpack(W)ᵀ · alpha`` from packed 2-bit planes.

    Args:
        x: (M, K) activations.
        w_packed: (N, K_pad/4) uint8 planes from ``pack_planar``, or
            (N, K_pad/16) int32 words from ``pack_planar32``.
        w_shape: (N, K) logical weight shape.
        alpha: scalar scale (the TTQ positive scale with ``alpha_neg``).
        layout: ``'planar'`` or ``'planar32'``; the ``rows`` and ``flat``
            layouts are not ported yet (ROADMAP.md, slice F).
        alpha_neg: optional TTQ negative scale: computes
            ``x @ (alpha·[w=+1] − alpha_neg·[w=−1])ᵀ`` from the same planes.
    """
    if layout not in ("planar", "planar32"):
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet (ROADMAP.md, slice F); "
            f"use layout='planar' or 'planar32'")
    n, k = w_shape
    if kernel_eligible((x.shape[0], k), (n, k)):
        avec = _alpha_vec(alpha, alpha_neg, x.device)
        kernel = (ternary_matmul_planar32 if layout == "planar32"
                  else ternary_matmul_planar)
        return kernel(x.float().contiguous(), w_packed, k, avec,
                      asym=alpha_neg is not None).to(x.dtype)
    unpack = unpack_planar32 if layout == "planar32" else unpack_planar
    w = unpack(w_packed, k, dtype=x.dtype)
    return _scaled_matmul(x, w, alpha, alpha_neg)


def packed_ternary_matmul_rpb(x: torch.Tensor, w_packed_planar: torch.Tensor,
                              correction: torch.Tensor, w_shape,
                              alpha=1.0) -> torch.Tensor:
    """``x @ (unpack(Wp)·alpha + correction)ᵀ`` from uint8 planes and the
    dense (N, K) bf16 RPB correction: the fused kernel for eligible shapes,
    otherwise the blended weight and ``torch.matmul``, as JAX's XLA
    fallback computes it."""
    n, k = w_shape
    if kernel_eligible((x.shape[0], k), (n, k)):
        avec = _alpha_vec(alpha, None, x.device)
        return ternary_matmul_rpb(x.float().contiguous(), w_packed_planar,
                                  correction.contiguous(), k,
                                  avec).to(x.dtype)
    w = unpack_planar(w_packed_planar, k, dtype=x.dtype)
    w_eff = w * torch.as_tensor(alpha, dtype=x.dtype, device=x.device) \
        + correction.to(x.dtype)
    return torch.matmul(x, w_eff.T)
