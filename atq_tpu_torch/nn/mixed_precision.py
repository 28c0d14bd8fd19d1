"""Importance-controlled layers (port of atq_tpu/nn/mixed_precision.py,
which no command-line tool calls; part of the public API).

- :class:`PrecisionControlledLinear`: an RPB layer whose precision ratio
  and sparsity target come from an importance score (or a TernaryLinear
  at the quantizer's defaults without RPB), as submodule ``linear``.
- :class:`EnhancedATQTransformerLayer`: a post-norm transformer layer with
  importance-scaled precision per sublayer (later layers and attention get
  more precision); exact GELU.

Unlike flax, a PyTorch layer is built knowing its input width, so both
take ``in_features``/``embed_dim`` first. Module names are the JAX ones
(``query``, ``key``, ``value``, ``attn_out``, ``norm1``, ``ff1``, ``ff2``,
``norm2``, each ``*/linear``), so utils/jax_interop.py carries a JAX init
across. Built in eval mode; ``forward``'s ``generator`` draws the dropout
masks when not ``deterministic``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from atq_tpu_torch.core.schedules import MixedPrecisionATQ
from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    TernaryLinear,
    apply_selective_routing,
    dropout,
)
from atq_tpu_torch.utils.platform import resolve_device


class PrecisionControlledLinear(nn.Module):
    """Linear layer whose precision_ratio / sparsity_target are derived
    from an importance score."""

    def __init__(self, in_features: int, features: int,
                 importance: float = 1.0, base_sparsity: float = 0.3,
                 base_precision_ratio: float = 0.05, use_bias: bool = True,
                 use_rpb: bool = True, grad_mode: str = "parity",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_rpb:
            self.linear = ResidualPrecisionBoostLinear(
                in_features, features,
                precision_ratio=MixedPrecisionATQ.get_precision_ratio(
                    importance, base_ratio=base_precision_ratio),
                sparsity_target=MixedPrecisionATQ.get_sparsity_target(
                    importance, base_sparsity=base_sparsity),
                use_bias=use_bias, grad_mode=grad_mode, device="cpu",
                generator=generator)
        else:
            self.linear = TernaryLinear(in_features, features,
                                        use_bias=use_bias,
                                        grad_mode=grad_mode, device="cpu",
                                        generator=generator)
        self.to(resolve_device(device))

    def forward(self, x):
        return self.linear(x)


class EnhancedATQTransformerLayer(nn.Module):
    """Post-norm transformer layer with importance-scaled precision per
    sublayer; routing thresholds decay with depth."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 use_rpb: bool = True, base_sparsity: float = 0.3,
                 layer_idx: int = 0, total_layers: int = 4,
                 grad_mode: str = "parity", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (embed_dim // num_heads) * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.layer_idx = dropout, layer_idx
        layer_importance = 1.0 + layer_idx / max(1, total_layers - 1)
        attn_importance = layer_importance * 1.2
        ff_importance = layer_importance * 0.8

        def pcl(fan_in, features, importance):
            return PrecisionControlledLinear(
                fan_in, features, importance=importance,
                base_sparsity=base_sparsity, use_rpb=use_rpb,
                grad_mode=grad_mode, device="cpu", generator=generator)

        self.query = pcl(embed_dim, embed_dim, attn_importance)
        self.key = pcl(embed_dim, embed_dim, attn_importance)
        self.value = pcl(embed_dim, embed_dim, attn_importance)
        self.attn_out = pcl(embed_dim, embed_dim, attn_importance * 1.1)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.ff1 = pcl(embed_dim, dim_feedforward, ff_importance)
        self.ff2 = pcl(dim_feedforward, embed_dim, ff_importance * 1.2)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        def drop(t):
            return dropout(t, self.dropout, deterministic, generator)

        batch, head_dim = x.shape[0], self.embed_dim // self.num_heads
        threshold = max(0.01, 0.05 * (1.0 - self.layer_idx / 10))
        q, k, v = (apply_selective_routing(proj(x), threshold=threshold)
                   for proj in (self.query, self.key, self.value))

        def split(t):
            return t.reshape(batch, -1, self.num_heads,
                             head_dim).transpose(1, 2)

        scores = torch.einsum("bhqd,bhkd->bhqk", split(q),
                              split(k)) / math.sqrt(head_dim)
        if mask is not None:
            scores = scores.masked_fill(torch.as_tensor(mask) == 0,
                                        float("-inf"))
        attn = drop(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhqk,bhkd->bhqd", attn, split(v))
        out = self.attn_out(out.transpose(1, 2).reshape(batch, -1,
                                                        self.embed_dim))
        # Post-norm residuals (unlike the pre-norm TernaryTransformerLayer).
        x = self.norm1(x + drop(out))
        h = drop(torch.nn.functional.gelu(self.ff1(x)))
        return self.norm2(x + drop(self.ff2(h)))
