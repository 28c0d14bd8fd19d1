"""Quantized linear layers, eval forward (port of atq_tpu/nn/layers.py).

- :class:`TernaryLinear` and :class:`ResidualPrecisionBoostLinear` keep the
  JAX layers' state under the same names: ``weight`` (out, in), ``alpha``
  (1,), ``bias``, TTQ ``wp``/``wn``, and for RPB the ``precision_mask``
  (bool) and ``sparsity_target`` (f32 scalar) buffers that the JAX side
  keeps in its 'quant' collection.
- A layer with a ``packed_entry`` (serve/packed_model.py) serves from its
  2-bit planes, as the JAX layers do when a 'packed' collection is present.
- Only the forward is ported; the gradient modes' backward rules come with
  the training slice. ``grad_mode`` selects the forward: 'parity' and
  'ste' share it, 'ttq' uses the two learned scales.

Parameters are drawn on the CPU from an explicit ``torch.Generator`` and
then moved to the layer's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from atq_tpu_torch.core.quantize import (
    adaptive_ternary_quantization,
    ternarize_ttq,
    ternary_threshold,
)
from atq_tpu_torch.nn.initializers import (
    bias_uniform_torch_,
    kaiming_uniform_torch_,
)
from atq_tpu_torch.utils.platform import resolve_device

DEFAULT_SPARSITY = 0.3
GRAD_MODES = ("parity", "ste", "ttq")


def apply_selective_routing(x, threshold: float = 0.05,
                            importance_factor: float = 0.3):
    """Identity pass-through, as in the JAX package (the reference's
    applied routing function returns its input unchanged)."""
    del threshold, importance_factor
    return x


def _ttq_scale(weight: torch.Tensor, sparsity_target, positive: bool):
    """Data-dependent TTQ scale init: mean |w| of the side it quantizes."""
    thr = ternary_threshold(weight, sparsity_target=sparsity_target)
    m = (weight > thr) if positive else (weight < -thr)
    m = m.to(weight.dtype)
    s = (weight.abs() * m).sum() / torch.clamp(m.sum(), min=1.0)
    return s.reshape(1)


def _precision_mask(weight: torch.Tensor,
                    precision_ratio: float) -> torch.Tensor:
    """Bool mask of the top ``precision_ratio`` fraction of |w| at init.
    ``torch.topk`` may break ties differently from ``jax.lax.top_k``, so
    cross-checks load the JAX mask instead of recomputing it."""
    flat = weight.abs().reshape(-1)
    k = int(precision_ratio * flat.numel())
    mask = torch.zeros(flat.shape, dtype=torch.bool)
    if k > 0:
        mask[torch.topk(flat, k).indices] = True
    return mask.reshape(weight.shape)


def _packed_forward(entry, x, features: int):
    from atq_tpu_torch.serve.packed_model import packed_linear_apply

    lead = x.shape[:-1]
    y = packed_linear_apply(entry, x.reshape(-1, x.shape[-1]))
    return y.reshape(*lead, features)


class _QuantizedLinear(nn.Module):
    """State shared by the two layers: weight, alpha, bias, TTQ scales."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool,
                 grad_mode: str, generator: Optional[torch.Generator]):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode must be one of {GRAD_MODES}")
        self.in_features = in_features
        self.out_features = out_features
        self.grad_mode = grad_mode
        weight = torch.empty(out_features, in_features)
        kaiming_uniform_torch_(weight, math.sqrt(5), generator=generator)
        self.weight = nn.Parameter(weight)
        self.alpha = nn.Parameter(torch.ones(1))
        if use_bias:
            bias = torch.empty(out_features)
            bias_uniform_torch_(bias, in_features, generator=generator)
            self.bias = nn.Parameter(bias)
        else:
            self.bias = None
        # Serving entry (serve/packed_model.py:attach_packed_collection).
        self.packed_entry = None

    def _init_ttq(self, sparsity_target) -> None:
        with torch.no_grad():
            self.wp = nn.Parameter(_ttq_scale(self.weight, sparsity_target,
                                              True))
            self.wn = nn.Parameter(_ttq_scale(self.weight, sparsity_target,
                                              False))

    def _finish(self, x, w_eff):
        y = torch.matmul(x, w_eff.T)
        if self.bias is not None:
            y = y + self.bias
        return y


class TernaryLinear(_QuantizedLinear):
    """Linear layer over ternarized weights with a learnable scalar alpha.
    Uses the quantizer defaults (sparsity 0.3), as the JAX layer does."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, grad_mode: str = "parity",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, use_bias, grad_mode,
                         generator)
        if grad_mode == "ttq":
            self._init_ttq(DEFAULT_SPARSITY)
        self.to(resolve_device(device))

    def forward(self, x):
        if self.packed_entry is not None:
            return _packed_forward(self.packed_entry, x, self.out_features)
        if self.grad_mode == "ttq":
            w_eff = ternarize_ttq(self.weight, self.wp, self.wn,
                                  sparsity_target=DEFAULT_SPARSITY)
        else:
            w_t, a = adaptive_ternary_quantization(
                self.weight, alpha=self.alpha,
                sparsity_target=DEFAULT_SPARSITY)
            w_eff = w_t * a
        return self._finish(x, w_eff)


class ResidualPrecisionBoostLinear(_QuantizedLinear):
    """TernaryLinear plus a fixed full-precision residual on the top
    ``precision_ratio`` of weights by |w| at init:
    ``w_mixed = w_t·alpha·(1 − mask) + w·mask``."""

    def __init__(self, in_features: int, out_features: int,
                 precision_ratio: float = 0.05, use_bias: bool = True,
                 sparsity_target: float = DEFAULT_SPARSITY,
                 grad_mode: str = "parity", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, use_bias, grad_mode,
                         generator)
        self.precision_ratio = precision_ratio
        self.register_buffer("precision_mask",
                             _precision_mask(self.weight.detach(),
                                             precision_ratio))
        self.register_buffer("sparsity_target",
                             torch.tensor(sparsity_target,
                                          dtype=torch.float32))
        if grad_mode == "ttq":
            self._init_ttq(sparsity_target)
        self.to(resolve_device(device))

    def forward(self, x):
        if self.packed_entry is not None:
            return _packed_forward(self.packed_entry, x, self.out_features)
        mask = self.precision_mask.to(self.weight.dtype)
        if self.grad_mode == "ttq":
            w_t = ternarize_ttq(self.weight, self.wp, self.wn,
                                sparsity_target=self.sparsity_target)
            w_mixed = w_t * (1.0 - mask) + self.weight * mask
        else:
            w_t, a = adaptive_ternary_quantization(
                self.weight, alpha=self.alpha,
                sparsity_target=self.sparsity_target)
            w_mixed = w_t * a * (1.0 - mask) + self.weight * mask
        return self._finish(x, w_mixed)
