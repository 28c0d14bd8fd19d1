"""ATQ text encoder (port of atq_tpu/models/text_encoder.py).

Full-precision embedding (N(0, 0.02)) + embedding LayerNorm + a fixed
sinusoidal positional encoding + dropout, N ternary transformer layers, a
final LayerNorm, attention pooling, and a learnable output scaling clamped
to [1, 10].

Kept from the JAX module:
- the double-softmax pooling quirk: the pooling MLP ends in a softmax over
  the sequence, and with a padding mask the already-softmaxed weights are
  masked to -inf and softmaxed a second time;
- the positional table is a buffer (``positional_encoding``, (1, L, D)),
  the JAX 'constants' collection, loaded from a checkpoint when it has one;
- ``src_key_padding_mask`` may be a boolean mask (True = pad) or lengths;
- the unrolled stack is ``layers_{i}``; ``scan_layers`` builds the
  ``ScannedTernaryStack`` (``layers.scan.layer.*``).

``moe_experts > 0`` gives every unrolled layer the ternary-expert MoE FFN
(nn/transformer.py); ``forward``'s ``moe_aux`` list collects their
load-balance losses. ``scan_layers`` with ``moe_experts > 0`` raises
ValueError, as in JAX. :func:`apply_reference_text_init` is the
reference's from-scratch init. Dropout masks come from the ``generator``
passed to ``forward``. ``dtype`` is the layers' matmul compute dtype (AMP);
the embedding, the LayerNorms and the pooling's softmax stay float32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from atq_tpu_torch.nn.attention import (
    LayerNorm32,
    _proj,
    lengths_to_padding_mask,
)
from atq_tpu_torch.nn.initializers import normal_std_
from atq_tpu_torch.nn.layers import dropout
from atq_tpu_torch.nn.transformer import (
    ScannedTernaryStack,
    TernaryTransformerLayer,
)
from atq_tpu_torch.utils.platform import resolve_device


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The fixed sin/cos table, (1, max_len, d_model) float32."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32)
        * (-math.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


class ATQTextEncoder(nn.Module):
    """Token ids (B, L) -> pooled text features (B, embed_dim). Built in
    eval mode."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 num_heads: int = 8, num_layers: int = 4,
                 dim_feedforward: int = 512, dropout: float = 0.1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 max_seq_length: int = 256, grad_mode: str = "parity",
                 moe_experts: int = 0, scan_layers: bool = False,
                 attn_impl: str = "einsum", dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if scan_layers and moe_experts > 0:
            raise ValueError(
                "scan_layers does not support moe_experts > 0 — the "
                "per-layer aux-loss sow needs the unrolled stack")
        initial_sparsity = min(0.1, sparsity_target)
        self.dropout = dropout
        self.num_layers = num_layers
        self.scan_layers = scan_layers
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        normal_std_(self.embedding.weight, 0.02, generator=generator)
        self.embed_norm = LayerNorm32(embed_dim)
        self.register_buffer("positional_encoding", torch.from_numpy(
            sinusoidal_positional_encoding(max_seq_length, embed_dim)))
        if scan_layers:
            self.layers = ScannedTernaryStack(
                num_layers, embed_dim, num_heads,
                dim_feedforward=dim_feedforward, dropout=dropout,
                use_rpb=use_rpb, sparsity_target=initial_sparsity,
                grad_mode=grad_mode, dtype=dtype, attn_impl=attn_impl,
                device="cpu", generator=generator)
        else:
            for i in range(num_layers):
                setattr(self, f"layers_{i}", TernaryTransformerLayer(
                    embed_dim, num_heads, dim_feedforward=dim_feedforward,
                    dropout=dropout, use_rpb=use_rpb,
                    sparsity_target=initial_sparsity, layer_idx=i,
                    grad_mode=grad_mode, dtype=dtype, attn_impl=attn_impl,
                    moe_experts=moe_experts, device="cpu",
                    generator=generator))
        self.norm = LayerNorm32(embed_dim)
        self.attention_pool_0 = _proj(use_rpb, embed_dim, embed_dim // 2,
                                      0.2, initial_sparsity, grad_mode, dtype,
                                      generator=generator)
        self.attention_pool_2 = _proj(use_rpb, embed_dim // 2, 1, 0.2,
                                      initial_sparsity, grad_mode, dtype,
                                      generator=generator)
        self.scaling = nn.Parameter(torch.full((1,), 4.0))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x, src_key_padding_mask=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                moe_aux: Optional[List[torch.Tensor]] = None):
        """``moe_aux``: a list that each MoE layer appends its
        load-balance loss to."""
        if src_key_padding_mask is not None:
            src_key_padding_mask = torch.as_tensor(src_key_padding_mask,
                                                   device=x.device)
            if src_key_padding_mask.ndim == 1:
                src_key_padding_mask = lengths_to_padding_mask(
                    src_key_padding_mask, x.shape[1])
        h = self.embed_norm(self.embedding(x))
        h = h + self.positional_encoding[:, :h.shape[1], :]
        h = dropout(h, self.dropout, deterministic, generator)
        if self.scan_layers:
            h = self.layers(h, src_key_padding_mask=src_key_padding_mask,
                            deterministic=deterministic,
                            generator=generator).float()
        else:
            for i in range(self.num_layers):
                h = getattr(self, f"layers_{i}")(
                    h, src_key_padding_mask=src_key_padding_mask,
                    deterministic=deterministic, generator=generator,
                    moe_aux=moe_aux)
        h = self.norm(h)
        a = torch.tanh(self.attention_pool_0(h))
        a = self.attention_pool_2(a)
        attn_weights = torch.softmax(a, dim=1)  # (B, L, 1)
        if src_key_padding_mask is not None:
            # The double softmax: mask the softmaxed weights, renormalize.
            attn_weights = torch.softmax(attn_weights.masked_fill(
                src_key_padding_mask[:, :, None], float("-inf")), dim=1)
        text_features = torch.sum(h * attn_weights, dim=1)
        return text_features * torch.clamp(self.scaling, 1.0, 10.0)


def apply_reference_text_init(variables: dict,
                              generator: Optional[torch.Generator] = None
                              ) -> dict:
    """The reference's ``_init_parameters`` on JAX-layout variables (nested
    dicts of numpy arrays, e.g. ``ATQTextEncoder``'s state through
    ``utils.jax_interop.to_jax_variables``), for strict-parity from-scratch
    runs: xavier_uniform(gain=0.8) on EVERY parameter with ndim > 1 (a
    scanned stack's leaves by their per-layer rank), then N(0, 0.02) on the
    embedding; the positional-encoding constant, which the reference
    clobbers by accident, is drawn from the same xavier rule. Other leaves
    are kept. Values are drawn from ``generator``; the input is not
    mutated."""
    gain = 0.8

    def xavier(shape):
        bound = gain * np.sqrt(6.0 / (shape[-1] + shape[-2]))
        return torch.empty(shape).uniform_(-bound, bound,
                                           generator=generator).numpy()

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        shape = np.shape(node)
        eff_ndim = len(shape) - 1 if "scan" in keys else len(shape)
        if keys[-1] == "embedding":
            return (0.02 * torch.randn(shape, generator=generator)).numpy()
        return xavier(shape) if eff_ndim > 1 else node

    out = {**variables, "params": walk(variables["params"], ())}
    constants = dict(variables.get("constants", {}))
    if constants.get("positional_encoding") is not None:
        constants["positional_encoding"] = xavier(
            np.shape(constants["positional_encoding"]))
    out["constants"] = constants
    return out
