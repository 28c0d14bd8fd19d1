"""Quantized linear layers and selective gradient routing (port of
atq_tpu/nn/layers.py).

- :class:`TernaryLinear` and :class:`ResidualPrecisionBoostLinear` keep the
  JAX layers' state under the same names: ``weight`` (out, in), ``alpha``
  (1,), ``bias``, TTQ ``wp``/``wn``, and for RPB the ``precision_mask``
  (bool) and ``sparsity_target`` (f32 scalar) buffers that the JAX side
  keeps in its 'quant' collection.
- A layer with a ``packed_entry`` (serve/packed_model.py) serves from its
  2-bit planes, as the JAX layers do when a 'packed' collection is present.
- ``grad_mode`` selects the backward rule: 'parity' (the reference's: the
  latent weight of a TernaryLinear gets no gradient, an RPB layer's only on
  its masked entries), 'ste' (straight-through) or 'ttq' (two learned
  scales, core/quantize.py).
- The fused path (``fused=True``, or ``ATQ_FUSED=1`` when ``fused`` is
  None, the JAX rule) computes the threshold on the detached weight and
  runs ternarize + blend + matmul as one op (ops/fused_linear.py): on the
  card its forward, dx and dW/dalpha are the CUDA kernels of
  ``csrc/fused_linear.cu``. It covers 'parity' and 'ste'; 'ttq' always
  takes the dense path, as in JAX.
- ``dtype`` is the matmul compute dtype (AMP, as the JAX layers' ``dtype``):
  the latent weight, the quantizer and alpha stay float32; x and the
  effective weight are cast at the matmul, and the float32 bias is added
  after it, so the output promotes to float32 as in JAX. ``ATQ_FUSED=1``
  does not route such a layer to the float32 fused kernels.
- ``pre_quantized`` (hoisted quantization, nn/hoist.py): the ``weight`` the
  layer is given is already the effective weight, and the forward is a
  plain matmul. The scanned stack runs its dense layers this way.
- ``threshold``, a buffer that is None unless a caller supplies it through
  ``functional_call``: the fused path then takes it instead of computing
  the quantizer threshold. The scanned stack computes it outside a
  rematerialized layer, so the recompute does not run the order statistic
  again (JAX's remat policy saves the threshold likewise).

Under tensor parallelism (``tp``, a ``ModelShard`` set by
parallel/sharded_model.py) a layer holds an out-features shard of
``weight`` and ``precision_mask``; ``alpha``, the TTQ scales and ``bias``
stay whole. The dense path quantizes the gathered weight (its threshold,
through the order-statistic kernel, is the whole layer's) and multiplies by
the shard's rows; the fused path runs its kernels on the shard with the
whole layer's threshold. Either way the input's gradient and alpha's are
summed over the 'model' group and the output is gathered along features.

Parameters are drawn on the CPU from an explicit ``torch.Generator`` and
then moved to the layer's device.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn

from atq_tpu_torch.core.quantize import (
    adaptive_ternary_quantization,
    ternarize_ste,
    ternarize_ttq,
    ternary_threshold,
)
from atq_tpu_torch.nn.initializers import (
    bias_uniform_torch_,
    kaiming_uniform_torch_,
)
from atq_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_features,
    gather_model_rows,
    gather_model_shards,
    rand_rows,
)
from atq_tpu_torch.utils.platform import resolve_device

DEFAULT_SPARSITY = 0.3
GRAD_MODES = ("parity", "ste", "ttq")


def _use_fused(fused: Optional[bool], dtype=None) -> bool:
    """The layer's fused flag: an explicit ``fused`` wins, otherwise
    ``ATQ_FUSED == "1"`` (default "0", dense) for a float32 layer only (no
    AMP ``dtype``), as in the JAX package (nn/layers.py:96-114)."""
    if fused is not None:
        return fused
    return os.environ.get("ATQ_FUSED", "0") == "1" and dtype is None


def dropout(x, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None):
    """flax ``nn.Dropout``: keep each unit with probability 1 − rate and
    scale the kept ones by 1 / (1 − rate). The mask is drawn from
    ``generator`` (on ``x``'s device), so a caller that seeds it gets the
    same masks every run; a data-parallel rank draws the global batch's
    mask and keeps its rows (parallel/collectives.py ``rand_rows``)."""
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = rand_rows(x.shape, generator, x.device) < keep_prob
    return torch.where(keep, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def apply_selective_routing(x, threshold: float = 0.05,
                            importance_factor: float = 0.3):
    """Identity pass-through, as in the JAX package (the reference's
    applied routing function returns its input unchanged)."""
    del threshold, importance_factor
    return x


class _RoutedIdentity(torch.autograd.Function):
    """Identity forward; the backward keeps the gradient only where |x|
    is above its k-th smallest value, k = int((1 − importance) · n)
    (layers.py:127-151, torch.kthvalue semantics, 1-indexed)."""

    @staticmethod
    def forward(ctx, x, importance_factor: float):
        ctx.save_for_backward(x)
        ctx.importance_factor = importance_factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        importance = x.abs()
        n = importance.numel()
        k = int((1.0 - ctx.importance_factor) * n)
        if k < n:
            threshold = torch.sort(importance.reshape(-1)).values[max(k - 1,
                                                                      0)]
        else:
            threshold = torch.zeros((), dtype=x.dtype, device=x.device)
        return g * (importance > threshold).to(g.dtype), None


def selective_gradient_routing(x, threshold: float = 0.05,
                               importance_factor: float = 0.3):
    """Full routing variant: identity forward, backward masks the gradient
    to the top ``importance_factor`` fraction of activations by |x|. Not on
    the parity path (the reference never calls it)."""
    del threshold  # unused by the reference backward as well
    return _RoutedIdentity.apply(x, importance_factor)


# The JAX package's name for the same routing (a function, not a class).
SelectiveGradientRouting = selective_gradient_routing


def _quantize(weight, alpha, sparsity_target, grad_mode: str):
    if grad_mode == "ste":
        return ternarize_ste(weight, alpha=alpha,
                             sparsity_target=sparsity_target)
    return adaptive_ternary_quantization(weight, alpha=alpha,
                                         sparsity_target=sparsity_target)


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
                 grad_mode: str, fused: Optional[bool],
                 generator: Optional[torch.Generator], dtype=None,
                 pre_quantized: bool = False):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode must be one of {GRAD_MODES}")
        self.in_features = in_features
        self.out_features = out_features
        self.grad_mode = grad_mode
        self.fused = fused
        self.dtype = dtype
        self.pre_quantized = pre_quantized
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
        self.register_buffer("threshold", None, persistent=False)
        # Tensor parallelism: a ModelShard when this layer holds an
        # out-features shard (parallel/sharded_model.py).
        self.tp = None

    def _init_ttq(self, sparsity_target) -> None:
        with torch.no_grad():
            self.wp = nn.Parameter(_ttq_scale(self.weight, sparsity_target,
                                              True))
            self.wn = nn.Parameter(_ttq_scale(self.weight, sparsity_target,
                                              False))

    def _fused_forward(self, x, sparsity_target, mask=None):
        from atq_tpu_torch.ops.fused_linear import fused_quantized_linear

        thr, alpha = self.threshold, self.alpha
        if self.tp is not None:  # the kernels run on the shard
            thr = ternary_threshold(gather_model_rows(self.weight, self.tp),
                                    sparsity_target=sparsity_target)
            x, alpha = copy_to_model(x, self.tp), copy_to_model(alpha,
                                                                self.tp)
        elif thr is None:
            thr = ternary_threshold(self.weight,
                                    sparsity_target=sparsity_target)
        y = fused_quantized_linear(x, self.weight, alpha, thr, mask=mask,
                                   grad_mode=self.grad_mode)
        return self._add_bias(y)

    def _add_bias(self, y):
        if self.tp is not None:
            y = gather_features(y, self.tp)
        return y if self.bias is None else y + self.bias

    def _finish(self, x, w_eff):
        if self.tp is not None:  # this shard's rows of the whole layer's
            n = w_eff.shape[0] // self.tp.count
            w_eff = w_eff[self.tp.index * n:(self.tp.index + 1) * n]
            x = copy_to_model(x, self.tp)
        if self.dtype is not None:
            x, w_eff = x.to(self.dtype), w_eff.to(self.dtype)
        return self._add_bias(torch.matmul(x, w_eff.T))

    def _whole(self, name: str):
        """The layer's ``name`` tensor whole: under tensor parallelism the
        out-features shards gathered (a weight with the gradient's true
        adjoint, the shard's rows summed over the group) and a scalar
        carried into the group (its gradient summed over it), so the
        quantizer sees the whole layer, its threshold included."""
        t = getattr(self, name)
        if self.tp is None:
            return t
        if name == "precision_mask":
            return gather_model_rows(t, self.tp)
        if name == "weight":
            return gather_model_shards(t, self.tp)
        return copy_to_model(t, self.tp)


class TernaryLinear(_QuantizedLinear):
    """Linear layer over ternarized weights with a learnable scalar alpha.
    Uses the quantizer defaults (sparsity 0.3), as the JAX layer does."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, grad_mode: str = "parity",
                 fused: Optional[bool] = None, device=None,
                 generator: Optional[torch.Generator] = None, dtype=None,
                 pre_quantized: bool = False):
        super().__init__(in_features, out_features, use_bias, grad_mode,
                         fused, generator, dtype, pre_quantized)
        if grad_mode == "ttq":
            self._init_ttq(DEFAULT_SPARSITY)
        self.to(resolve_device(device))

    def forward(self, x):
        if self.packed_entry is not None:
            return _packed_forward(self.packed_entry, x, self.out_features)
        if self.pre_quantized:
            return self._finish(x, self.weight)
        if self.grad_mode == "ttq":
            w_eff = ternarize_ttq(self._whole("weight"), self._whole("wp"),
                                  self._whole("wn"),
                                  sparsity_target=DEFAULT_SPARSITY)
        elif _use_fused(self.fused, self.dtype):
            return self._fused_forward(x, DEFAULT_SPARSITY)
        else:
            w_t, a = _quantize(self._whole("weight"), self._whole("alpha"),
                               DEFAULT_SPARSITY, self.grad_mode)
            w_eff = w_t * a
        return self._finish(x, w_eff)


class ResidualPrecisionBoostLinear(_QuantizedLinear):
    """TernaryLinear plus a fixed full-precision residual on the top
    ``precision_ratio`` of weights by |w| at init:
    ``w_mixed = w_t·alpha·(1 − mask) + w·mask``."""

    def __init__(self, in_features: int, out_features: int,
                 precision_ratio: float = 0.05, use_bias: bool = True,
                 sparsity_target: float = DEFAULT_SPARSITY,
                 grad_mode: str = "parity", fused: Optional[bool] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype=None, pre_quantized: bool = False):
        super().__init__(in_features, out_features, use_bias, grad_mode,
                         fused, generator, dtype, pre_quantized)
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
        if self.pre_quantized:  # the hoisted, mask-blended weight
            return self._finish(x, self.weight)
        if self.grad_mode != "ttq" and _use_fused(self.fused, self.dtype):
            # The bool buffer goes to the kernels as it lies (read as uint8).
            return self._fused_forward(x, self.sparsity_target,
                                       mask=self.precision_mask)
        weight = self._whole("weight")
        mask = self._whole("precision_mask").to(weight.dtype)
        if self.grad_mode == "ttq":
            w_t = ternarize_ttq(weight, self._whole("wp"), self._whole("wn"),
                                sparsity_target=self.sparsity_target)
            w_mixed = w_t * (1.0 - mask) + weight * mask
        else:
            w_t, a = _quantize(weight, self._whole("alpha"),
                               self.sparsity_target, self.grad_mode)
            w_mixed = w_t * a * (1.0 - mask) + weight * mask
        return self._finish(x, w_mixed)
