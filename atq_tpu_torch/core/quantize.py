"""Adaptive Ternary Quantization core (PyTorch port of atq_tpu/core/quantize.py).

Forward semantics are those of the JAX package, kept exact:

- threshold index ``idx = floor(float32(s) * float32(n))`` over the
  ascending sort of |w|, computed in float32 (a Python double would flip
  thresholds at rounding boundaries);
- ``idx >= n``: threshold = max|w| + 1 (all-zero output);
- ``idx == 0``: fallback ``threshold_factor * mean|w|``;
- strict comparisons: +1 where ``w > t``, -1 where ``w < -t``;
- optimal alpha ``sum(w * w_t) / nnz`` with a ``mean|w|`` fallback when the
  pattern is all zeros; a caller-provided alpha overrides it.

Large float32 tensors (``n >= 16,384``) take the order-statistic kernel
(ops/order_stat.py), which returns the rank statistic, max and sum in one
call; smaller ones use ``torch.sort``, as the JAX side uses ``jnp.sort``.
Every step stays on the tensor's device: the rank is a device value and
nothing here synchronises with the host.

Gradient rules, as in the JAX package:

- parity (:func:`adaptive_ternary_quantization`): the ternary pattern is
  built by ``torch.where`` from constant branches, so the latent weight
  gets no gradient through it (JAX's exact zeros); the optimal alpha, when
  no alpha is given, stays differentiable in the weights;
- STE (:func:`ternarize_ste`): ``_STEIdentity`` passes the upstream
  gradient straight to the latent weight;
- TTQ (:func:`ternarize_ttq`): ``_TTQCombine`` gives the scales their
  side's mean gradient and the weights the scale-weighted straight-through
  gradient.

The threshold runs on the detached weight: it only feeds strict compares,
and the order-statistic kernel is a launch outside autograd.

The ``*_batched`` functions take a STACKED weight (L, ...) — L independent
matrices on a leading axis, the scanned stack's layout — and give each
layer exactly what the per-layer function gives it: one batched
order-statistic call (ops/order_stat.py:order_statistic_reductions_batched)
computes all L thresholds. The sparsity target may be a scalar or an (L,)
vector; alpha and the TTQ scales may be one value or one per layer.
"""

from __future__ import annotations

import torch

# Below this size a plain sort is used; at and above it the order-statistic
# kernel (same cut as atq_tpu/core/quantize.py:_SELECT_MIN_SIZE).
_SELECT_MIN_SIZE = 16384


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device``: a tensor is cast there, a Python number
    is filled in on the device (no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).reshape(())
    return torch.full((), value, dtype=dtype, device=device)


def _threshold_rank(n: int, sparsity_target, device):
    """``(idx, rank)`` as int32 device tensors: ``idx = floor(s * n)`` in
    float32 and ``rank = clip(idx, 0, n - 1)``."""
    st = _scalar(sparsity_target, torch.float32, device)
    n_f32 = _scalar(float(n), torch.float32, device)
    idx = torch.floor(st * n_f32).to(torch.int32)
    return idx, idx.clamp(0, n - 1)


def ternary_threshold(weights: torch.Tensor, threshold_factor: float = 0.05,
                      sparsity_target=0.3) -> torch.Tensor:
    """The quantizer's sparsity-targeted threshold as a 0-d tensor (no
    gradient: it is computed from the detached weights)."""
    weights = weights.detach()
    dtype = weights.dtype
    abs_w = weights.abs()
    flat = abs_w.reshape(-1)
    n = flat.numel()
    idx, rank = _threshold_rank(n, sparsity_target, weights.device)

    if dtype == torch.float32 and n >= _SELECT_MIN_SIZE:
        from atq_tpu_torch.ops.order_stat import order_statistic_reductions

        thr_at_idx, max_w, sum_w = order_statistic_reductions(
            flat.contiguous(), rank)
        mean_w = sum_w / _scalar(float(n), torch.float32, weights.device)
    else:
        sorted_w = torch.sort(flat).values
        thr_at_idx = sorted_w.gather(0, rank.reshape(1).long()).reshape(())
        max_w = sorted_w[n - 1]
        mean_w = abs_w.mean()

    thr_all_zero = max_w + _scalar(1.0, dtype, weights.device)
    thr_fallback = (_scalar(threshold_factor, dtype, weights.device)
                    * mean_w.to(dtype))
    return torch.where(idx >= n, thr_all_zero,
                       torch.where(idx > 0, thr_at_idx.to(dtype),
                                   thr_fallback))


def adaptive_ternary_quantization(weights: torch.Tensor, alpha=None,
                                  threshold_factor: float = 0.05,
                                  sparsity_target=0.3):
    """Sparsity-targeted ternarization. Returns ``(w_ternary, alpha)``:
    a {-1, 0, +1} tensor of the weights' shape and dtype, and the scale
    (the optimal one unless ``alpha`` is given)."""
    dtype = weights.dtype
    threshold = ternary_threshold(weights, threshold_factor, sparsity_target)
    one = torch.ones((), dtype=dtype, device=weights.device)
    zero = torch.zeros((), dtype=dtype, device=weights.device)
    w_ternary = torch.where(weights > threshold, one,
                            torch.where(weights < -threshold, -one, zero))
    if alpha is not None:
        return w_ternary, alpha
    nonzero_count = (w_ternary != 0).sum().to(dtype)
    optimal_alpha = torch.where(
        nonzero_count > 0,
        (weights * w_ternary).sum() / torch.maximum(nonzero_count, one),
        weights.abs().mean(),
    )
    return w_ternary, optimal_alpha


def _per_layer(value, lead: int, dtype, device) -> torch.Tensor:
    """A scalar or (L, ...) value as an (L,) tensor: one value is spread
    over the layers, otherwise the first element of each layer's slice is
    taken (as the JAX package's ``reshape(lead, -1)[:, 0]``)."""
    if not isinstance(value, torch.Tensor):
        return torch.full((lead,), float(value), dtype=dtype, device=device)
    value = value.to(device=device, dtype=dtype)
    if value.numel() == 1:
        return value.reshape(()).expand(lead)
    return value.reshape(lead, -1)[:, 0]


def ternary_threshold_batched(weights: torch.Tensor,
                              threshold_factor: float = 0.05,
                              sparsity_target=0.3) -> torch.Tensor:
    """Per-layer thresholds (L,) of a stacked (L, ...) weight, each equal
    to ``ternary_threshold(weights[l], …, sparsity_target[l])`` (no
    gradient: computed from the detached weights)."""
    weights = weights.detach()
    dtype, device = weights.dtype, weights.device
    lead = weights.shape[0]
    flat = weights.abs().reshape(lead, -1)
    n = flat.shape[1]
    st = _per_layer(sparsity_target, lead, torch.float32, device)
    idx = torch.floor(st * _scalar(float(n), torch.float32, device)).to(
        torch.int32)
    ranks = idx.clamp(0, n - 1)

    if dtype == torch.float32 and n >= _SELECT_MIN_SIZE:
        from atq_tpu_torch.ops.order_stat import (
            order_statistic_reductions_batched,
        )

        thr_at_idx, max_w, sum_w = order_statistic_reductions_batched(
            flat.contiguous(), ranks)
        mean_w = sum_w / _scalar(float(n), torch.float32, device)
    else:
        sorted_w = torch.sort(flat, dim=1).values
        thr_at_idx = sorted_w.gather(1, ranks.reshape(-1, 1).long())[:, 0]
        max_w = sorted_w[:, n - 1]
        mean_w = flat.mean(dim=1)

    thr_all_zero = max_w.to(dtype) + _scalar(1.0, dtype, device)
    thr_fallback = _scalar(threshold_factor, dtype, device) * mean_w.to(dtype)
    return torch.where(idx >= n, thr_all_zero,
                       torch.where(idx > 0, thr_at_idx.to(dtype),
                                   thr_fallback))


def _bshape(weights):
    return (weights.shape[0],) + (1,) * (weights.ndim - 1)


def adaptive_ternary_quantization_batched(weights: torch.Tensor, alpha=None,
                                          threshold_factor: float = 0.05,
                                          sparsity_target=0.3):
    """Batched :func:`adaptive_ternary_quantization` over a leading layer
    axis. Returns ``(w_ternary, alpha)`` with alpha shaped (L,): the
    per-layer optimal alpha, or the given one spread over the layers."""
    dtype, device = weights.dtype, weights.device
    lead = weights.shape[0]
    dims = tuple(range(1, weights.ndim))
    threshold = ternary_threshold_batched(
        weights, threshold_factor, sparsity_target).reshape(_bshape(weights))
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    w_ternary = torch.where(weights > threshold, one,
                            torch.where(weights < -threshold, -one, zero))
    if alpha is not None:
        return w_ternary, _per_layer(alpha, lead, dtype, device)
    nonzero = (w_ternary != 0).sum(dim=dims).to(dtype)
    optimal_alpha = torch.where(
        nonzero > 0,
        (weights * w_ternary).sum(dim=dims) / torch.maximum(nonzero, one),
        weights.abs().mean(dim=dims),
    )
    return w_ternary, optimal_alpha


def ternarize_ste_batched(weights: torch.Tensor, alpha=None,
                          threshold_factor: float = 0.05,
                          sparsity_target=0.3):
    """Batched :func:`ternarize_ste` (the STE identity is elementwise)."""
    w_ternary, alpha = adaptive_ternary_quantization_batched(
        weights, alpha, threshold_factor, sparsity_target)
    return _STEIdentity.apply(weights, w_ternary), alpha


class _TTQCombineBatched(torch.autograd.Function):
    """:class:`_TTQCombine` per layer of a stacked weight: (L,) scales, and
    each layer's scale gradients mean-normalized over that layer alone
    (quantize.py:320-349)."""

    @staticmethod
    def forward(ctx, weights, pos, neg, wp, wn):
        ctx.save_for_backward(pos, neg, wp, wn)
        b = _bshape(pos)
        return pos * wp.reshape(b) - neg * wn.reshape(b)

    @staticmethod
    def backward(ctx, g):
        pos, neg, wp, wn = ctx.saved_tensors
        b = _bshape(pos)
        dims = tuple(range(1, pos.ndim))
        dead = 1.0 - pos - neg
        dw = g * (pos * wp.reshape(b) + neg * wn.reshape(b) + dead)
        n_pos = torch.clamp(torch.sum(pos, dim=dims), min=1.0)
        n_neg = torch.clamp(torch.sum(neg, dim=dims), min=1.0)
        dwp = (torch.sum(g * pos, dim=dims) / n_pos).reshape(wp.shape)
        dwn = (-torch.sum(g * neg, dim=dims) / n_neg).reshape(wn.shape)
        return dw, None, None, dwp, dwn


def ternarize_ttq_batched(weights: torch.Tensor, wp, wn,
                          threshold_factor: float = 0.05,
                          sparsity_target=0.3):
    """Batched :func:`ternarize_ttq` over a leading layer axis; ``wp`` and
    ``wn`` are one value or one per layer."""
    dtype, device = weights.dtype, weights.device
    lead = weights.shape[0]
    threshold = ternary_threshold_batched(
        weights, threshold_factor, sparsity_target).reshape(_bshape(weights))
    pos = (weights > threshold).to(dtype)
    neg = (weights < -threshold).to(dtype)
    return _TTQCombineBatched.apply(weights, pos, neg,
                                    _per_layer(wp, lead, dtype, device),
                                    _per_layer(wn, lead, dtype, device))


class _STEIdentity(torch.autograd.Function):
    """Forward: the ternary pattern. Backward: the upstream gradient goes
    to the latent weights unchanged (quantize.py:373-388)."""

    @staticmethod
    def forward(ctx, weights, w_ternary):
        return w_ternary

    @staticmethod
    def backward(ctx, g):
        return g, None


def ternarize_ste(weights: torch.Tensor, alpha=None,
                  threshold_factor: float = 0.05, sparsity_target=0.3):
    """ATQ with a straight-through estimator: the forward is identical to
    :func:`adaptive_ternary_quantization`; in the backward the latent
    weights receive the full upstream gradient."""
    w_ternary, alpha = adaptive_ternary_quantization(
        weights, alpha, threshold_factor, sparsity_target)
    return _STEIdentity.apply(weights, w_ternary), alpha


class _TTQCombine(torch.autograd.Function):
    """``pos·wp − neg·wn`` with the TTQ gradient rule (quantize.py:411-440):
    the latent weights get ``g·(pos·wp + neg·wn + dead)`` with
    ``dead = 1 − pos − neg``, and the scales their side's gradient,
    mean-normalized: ``Σ g·pos / max(Σ pos, 1)`` and
    ``−Σ g·neg / max(Σ neg, 1)``."""

    @staticmethod
    def forward(ctx, weights, pos, neg, wp, wn):
        ctx.save_for_backward(pos, neg, wp, wn)
        return pos * wp - neg * wn

    @staticmethod
    def backward(ctx, g):
        pos, neg, wp, wn = ctx.saved_tensors
        dead = 1.0 - pos - neg
        dw = g * (pos * wp + neg * wn + dead)
        n_pos = torch.clamp(torch.sum(pos), min=1.0)
        n_neg = torch.clamp(torch.sum(neg), min=1.0)
        dwp = (torch.sum(g * pos) / n_pos).reshape(wp.shape)
        dwn = (-torch.sum(g * neg) / n_neg).reshape(wn.shape)
        return dw, None, None, dwp, dwn


def ternarize_ttq(weights: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
                  threshold_factor: float = 0.05, sparsity_target=0.3):
    """Trained Ternary Quantization: ``wp·[w>t] − wn·[w<−t]`` (scales
    folded in; callers must not multiply by alpha again), with the TTQ
    backward of :class:`_TTQCombine`."""
    threshold = ternary_threshold(weights, threshold_factor, sparsity_target)
    pos = (weights > threshold).to(weights.dtype)
    neg = (weights < -threshold).to(weights.dtype)
    return _TTQCombine.apply(weights, pos, neg, wp, wn)


def ternary_distribution(w_ternary: torch.Tensor) -> dict:
    """Fractions of {-1, 0, +1} values."""
    total = w_ternary.numel()
    return {
        "neg": (w_ternary == -1).sum() / total,
        "zero": (w_ternary == 0).sum() / total,
        "pos": (w_ternary == 1).sum() / total,
    }
