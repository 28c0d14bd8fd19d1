"""Hoisted quantization for the scanned ternary stack (port of
atq_tpu/nn/hoist.py).

Quantization depends only on parameters, never on activations, so the
stack (nn/transformer.py:ScannedTernaryStack) can compute every ternary
layer's effective weight once per step, before the layer loop, over the
stacked (L, out, in) tensors: one batched order-statistic launch per weight
kind (core/quantize.py:ternary_threshold_batched) and one elementwise chain
per kind. The layers then run in ``pre_quantized`` mode: plain matmuls on
the weights they are given. Ternary decisions are bit-identical to the
per-layer path, and the alpha/STE/TTQ gradient rules are the batched
equivalents of the per-layer ones.

The same function, with ``batched=False``, builds one layer's effective
weights; the stack uses it for the 'save_quantized' remat policy without
hoisting (quantize outside the checkpointed layer, so the backward reuses
the finished weights instead of re-running the quantizer).
"""

from __future__ import annotations

from typing import Dict

import torch

from atq_tpu_torch.core.quantize import (
    adaptive_ternary_quantization,
    adaptive_ternary_quantization_batched,
    ternarize_ste,
    ternarize_ste_batched,
    ternarize_ttq,
    ternarize_ttq_batched,
)
from atq_tpu_torch.nn.layers import DEFAULT_SPARSITY


def effective_weight(node: Dict[str, torch.Tensor], grad_mode: str, dtype,
                     batched: bool) -> torch.Tensor:
    """A ternary layer's effective weight exactly as its forward builds it:
    quantize -> scale -> RPB mask blend (when the node has a
    ``precision_mask``) -> AMP cast. ``node`` holds the layer's tensors by
    leaf name (``weight``, ``alpha``, ``wp``/``wn``, ``precision_mask``,
    ``sparsity_target``), stacked on a leading layer axis when ``batched``.
    """
    weight = node["weight"]
    sparsity = node.get("sparsity_target", DEFAULT_SPARSITY)
    if grad_mode == "ttq":
        if "wp" not in node or "wn" not in node:
            raise ValueError("grad_mode 'ttq' needs the layer's wp and wn "
                             "scales; the node has "
                             f"{sorted(node)}")
        ttq = ternarize_ttq_batched if batched else ternarize_ttq
        w_eff = ttq(weight, node["wp"], node["wn"], sparsity_target=sparsity)
    else:
        if batched:
            quantize = (ternarize_ste_batched if grad_mode == "ste"
                        else adaptive_ternary_quantization_batched)
        else:
            quantize = (ternarize_ste if grad_mode == "ste"
                        else adaptive_ternary_quantization)
        w_t, a = quantize(weight, alpha=node["alpha"],
                          sparsity_target=sparsity)
        if batched:
            a = a.reshape((weight.shape[0],) + (1,) * (weight.ndim - 1))
        w_eff = w_t * a
    mask = node.get("precision_mask")
    if mask is not None:
        m = mask.to(weight.dtype)
        w_eff = w_eff * (1.0 - m) + weight * m
    if dtype is not None:
        w_eff = w_eff.to(dtype)
    return w_eff


def effective_weights(tensors: Dict[str, torch.Tensor], grad_mode: str,
                      dtype, batched: bool) -> Dict[str, torch.Tensor]:
    """``{"<layer>.weight": effective weight}`` for every ternary layer in a
    flat name -> tensor dict (a layer is a prefix with both ``weight`` and
    ``alpha``), ready to override the latent weights of a
    ``pre_quantized`` layer."""
    out = {}
    for name in tensors:
        if name != "alpha" and not name.endswith(".alpha"):
            continue
        prefix = name[:-len("alpha")]
        node = {k[len(prefix):]: v for k, v in tensors.items()
                if k.startswith(prefix) and "." not in k[len(prefix):]}
        if "weight" in node:
            out[prefix + "weight"] = effective_weight(node, grad_mode, dtype,
                                                      batched)
    return out
