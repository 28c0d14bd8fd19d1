"""Ternary multi-head attention (port of atq_tpu/nn/attention.py).

- :class:`TernaryMultiheadAttention` keeps the JAX module's names and
  quirks: the pre-LayerNorm on the query only, the ``output + 0.1 * query``
  residual with the normalized query when ``critical_attention``, a
  boolean key-padding mask or 1-D lengths, and both attention branches:
  'einsum' (two batched products around a float32 softmax) and 'fused'
  (ops/fused_attention.py, the CUDA kernels on the card). The fused branch
  runs only without ``attn_mask``, without active dropout and for
  self-attention lengths, as in JAX; otherwise it takes the einsum branch,
  with a one-time warning when dropout is the reason.
- ``dtype`` is the projections' matmul dtype (AMP): their float32 bias
  promotes the outputs back to float32, so under AMP the attention itself
  runs in float32, as in JAX.

- :class:`TernaryCrossAttention` (the retrieval model's fusion): per-input
  LayerNorms, a learnable attention scale (init 1/sqrt(head_dim)), 2-D
  inputs as one-token sequences, a LayerNorm after the output projection
  and a sigmoid gate (init 0.8) blending in the normalized query.

Dropout masks come from the ``generator`` the caller passes to
``forward`` (nn/layers.py ``dropout``).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
from torch import nn

from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    TernaryLinear,
    apply_selective_routing,
    dropout,
)
from atq_tpu_torch.utils.platform import resolve_device

_warned_fused_dropout = False


def _warn_fused_dropout_fallback():
    """One-time notice that attn_impl='fused' runs the einsum branch because
    attention dropout is active (the fused kernels have no dropout)."""
    global _warned_fused_dropout
    if not _warned_fused_dropout:
        _warned_fused_dropout = True
        warnings.warn(
            "attn_impl='fused' requested but attention dropout is active "
            "(training with dropout > 0): falling back to the einsum "
            "attention path for these steps. Set dropout=0.0 (or run "
            "deterministically) to use the fused kernel.", stacklevel=3)


class LayerNorm32(nn.LayerNorm):
    """The JAX ``_norm``: LayerNorm with eps 1e-5, computed in float32
    whatever the input dtype (float32 output)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps)

    def forward(self, x):
        return super().forward(x.float())


def lengths_to_padding_mask(lengths, seq_length: int):
    """1-D lengths -> boolean (B, L) mask, True at padding positions."""
    lengths = torch.as_tensor(lengths)
    positions = torch.arange(seq_length, device=lengths.device)[None, :]
    return positions >= lengths[:, None]


def _proj(use_rpb: bool, in_features: int, features: int,
          precision_ratio: float, sparsity_target: float,
          grad_mode: str = "parity", dtype=None, pre_quantized: bool = False,
          generator: Optional[torch.Generator] = None):
    """One projection, built on the CPU (the owner moves it)."""
    if use_rpb:
        return ResidualPrecisionBoostLinear(
            in_features, features, precision_ratio=precision_ratio,
            sparsity_target=sparsity_target, grad_mode=grad_mode,
            dtype=dtype, pre_quantized=pre_quantized, device="cpu",
            generator=generator)
    return TernaryLinear(in_features, features, grad_mode=grad_mode,
                         dtype=dtype, pre_quantized=pre_quantized,
                         device="cpu", generator=generator)


class TernaryMultiheadAttention(nn.Module):
    """Multi-head self/cross attention over ATQ projections
    (atq_tpu/nn/attention.py:87-196). ``critical_attention`` raises the
    projections' precision ratio to 0.2 (out: 0.4) and adds the
    ``output + 0.1 * query`` residual."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 attention_scale: Optional[float] = None,
                 critical_attention: bool = False, grad_mode: str = "parity",
                 dtype=None, attn_impl: str = "einsum",
                 pre_quantized: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        head_dim = embed_dim // num_heads
        if head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if attn_impl not in ("einsum", "fused"):
            raise ValueError(f"attn_impl must be 'einsum' or 'fused', got "
                             f"{attn_impl!r}")
        self.embed_dim, self.num_heads, self.head_dim = (embed_dim, num_heads,
                                                         head_dim)
        self.dropout = dropout
        self.attention_scale = attention_scale
        self.critical_attention = critical_attention
        self.attn_impl = attn_impl
        # Initial sparsity: min(0.1, target), ramped by the schedule.
        initial_sparsity = min(0.1, sparsity_target)
        ratio = 0.2 if critical_attention else 0.05
        self.pre_layer_norm = LayerNorm32(embed_dim)
        for name, r in (("q_proj", ratio), ("k_proj", ratio),
                        ("v_proj", ratio), ("out_proj", ratio * 2)):
            setattr(self, name, _proj(use_rpb, embed_dim, embed_dim, r,
                                      initial_sparsity, grad_mode, dtype,
                                      pre_quantized, generator))
        self.to(resolve_device(device))

    def _split(self, t, batch):
        return t.reshape(batch, -1, self.num_heads,
                         self.head_dim).transpose(1, 2)

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        query = self.pre_layer_norm(query)
        batch = query.shape[0]
        threshold = 0.01 if self.critical_attention else 0.05
        q = apply_selective_routing(self.q_proj(query), threshold=threshold)
        k = apply_selective_routing(self.k_proj(key), threshold=threshold)
        v = apply_selective_routing(self.v_proj(value), threshold=threshold)
        q, k, v = (self._split(t, batch) for t in (q, k, v))

        scale = self.attention_scale or (1.0 / math.sqrt(self.head_dim))
        dropout_active = self.dropout > 0.0 and not deterministic
        if self.attn_impl == "fused" and dropout_active:
            _warn_fused_dropout_fallback()
        if key_padding_mask is not None:
            key_padding_mask = torch.as_tensor(key_padding_mask,
                                               device=q.device)
        if (self.attn_impl == "fused" and attn_mask is None
                and not dropout_active and q.shape[2] == k.shape[2]):
            from atq_tpu_torch.ops.fused_attention import (
                fused_attention,
                padding_bias,
            )

            bias = padding_bias(key_padding_mask, k.shape[2])
            out = fused_attention(q, k, v, float(scale), bias)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * scale
            if key_padding_mask is not None:
                if key_padding_mask.ndim == 1:
                    key_padding_mask = lengths_to_padding_mask(
                        key_padding_mask, scores.shape[-1])
                pad = key_padding_mask.bool()[:, None, None, :]
                scores = scores.masked_fill(pad, float("-inf"))
            if attn_mask is not None:
                scores = scores + attn_mask
            attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
            attn = dropout(attn, self.dropout, deterministic, generator)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(batch, -1, self.embed_dim)
        out = self.out_proj(out)
        if self.critical_attention:
            out = out + 0.1 * query
        return out


class TernaryCrossAttention(nn.Module):
    """Cross-modal attention with ATQ projections and a gated residual
    (atq_tpu/nn/attention.py:199-279). ``hidden_dim`` is also the width of
    the query, key and value inputs."""

    def __init__(self, hidden_dim: int, num_heads: int = 4,
                 dropout: float = 0.1, use_rpb: bool = True,
                 sparsity_target: float = 0.3, grad_mode: str = "parity",
                 dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        head_dim = hidden_dim // num_heads
        if head_dim * num_heads != hidden_dim:
            raise ValueError(f"hidden_dim {hidden_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.hidden_dim, self.num_heads, self.head_dim = (hidden_dim,
                                                          num_heads, head_dim)
        self.dropout = dropout
        initial_sparsity = min(0.1, sparsity_target)
        for name in ("layer_norm_q", "layer_norm_k", "layer_norm_v"):
            setattr(self, name, LayerNorm32(hidden_dim))
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, _proj(use_rpb, hidden_dim, hidden_dim, 0.15,
                                      initial_sparsity, grad_mode, dtype,
                                      generator=generator))
        self.attention_scale = nn.Parameter(
            torch.full((1,), 1.0 / math.sqrt(head_dim)))
        self.out_proj = _proj(use_rpb, hidden_dim, hidden_dim, 0.2,
                              initial_sparsity, grad_mode, dtype,
                              generator=generator)
        self.layer_norm_out = LayerNorm32(hidden_dim)
        self.gate = nn.Parameter(torch.full((1,), 0.8))
        self.to(resolve_device(device))

    def forward(self, query, key, value, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        batch = query.shape[0]
        query = self.layer_norm_q(query)
        key = self.layer_norm_k(key)
        value = self.layer_norm_v(value)
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)

        def split(t):
            if t.ndim == 2:
                t = t[:, None, :]
            return t.reshape(batch, -1, self.num_heads,
                             self.head_dim).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.attention_scale
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        attn = dropout(attn, self.dropout, deterministic, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(
            batch, -1, self.hidden_dim)
        if out.shape[1] == 1:
            out = out[:, 0, :]
        out = self.layer_norm_out(self.out_proj(out))
        if query.ndim == out.ndim and query.shape[-1] == out.shape[-1]:
            g = torch.sigmoid(self.gate)
            out = g * out + (1.0 - g) * query
        return out
