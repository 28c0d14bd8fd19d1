"""Mixture-of-experts FFN with ternary experts, on one device (port of
atq_tpu/parallel/moe.py: ``init_moe_params``, ``top1_dispatch`` and
``moe_ffn``).

- **Top-1 routing at a fixed capacity.** Each token takes the argmax
  expert of ``softmax(x @ gate)`` (a tie goes to the first index, as in
  JAX); an expert accepts at most ``capacity`` tokens, in token order. An
  overflow token gets a combine weight of 0, so the caller's residual
  carries it. The one-hot, its running count and the slot position are
  int32 whatever ``x``'s dtype, so no slot is shared under AMP.
- **Masked tokens** (``token_mask`` False: padding) take no capacity and
  no part in the load-balance statistics: ``expert_fraction`` and the mean
  probability count valid tokens only, and
  ``aux_loss = mean(frac · mean_prob) · E²``.
- **Dispatch and combine.** :func:`top1_dispatch` gives JAX's one-hot
  (T, E, C) tensors; :func:`moe_ffn` takes the same routing as two
  gathers (a slot's token, a token's slot), which under top-1 give the
  one-hot products' values bit for bit, hold no (T, E, C) tensor, and
  export with a symbolic batch (the capacity follows it).
- **Ternary experts.** With ``ternary`` each expert's planes are ternarized
  on their own, ``w_t · alpha`` (JAX: ``jax.vmap`` of
  ``adaptive_ternary_quantization``). Here one call quantizes a whole
  (E, ·, ·) stack: ``adaptive_ternary_quantization_batched``, whose
  thresholds come from ONE launch of the batched order statistic per
  stack on the card (a plane of 16,384 weights or more). The planes reach
  the loss only through the optimal alpha, ``sum(w · w_t) / nnz``.
- The expert FFN's GELU is the tanh form (``jax.nn.gelu``'s default),
  where the dense FFN's is exact.

``moe_ffn_sharded`` (expert parallelism over a process group) is not
ported yet (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from atq_tpu_torch.core.quantize import adaptive_ternary_quantization_batched


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_hidden: int, n_experts: int) -> Dict[str, torch.Tensor]:
    """The gate (D, E) and the expert planes w1 (E, D, H) and w2 (E, H, D),
    each ``N(0, 1)`` scaled by its fan-in ** -0.5, drawn from
    ``generator`` on the CPU."""
    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator) * fan_in ** -0.5

    return {"gate": normal((d_model, n_experts), d_model),
            "w1": normal((n_experts, d_model, d_hidden), d_model),
            "w2": normal((n_experts, d_hidden, d_model), d_hidden)}


def _ternarize_expert_planes(w: torch.Tensor, sparsity_target: float):
    """Each expert's plane of ``w`` (E, ...) as ``w_t · alpha``, quantized
    on its own."""
    w_t, alpha = adaptive_ternary_quantization_batched(
        w, sparsity_target=sparsity_target)
    return w_t * alpha.reshape((-1,) + (1,) * (w.ndim - 1))


def _route(x, gate_w, n_experts: int, capacity: int, token_mask):
    """Top-1 routing of (T, D) tokens: ``(onehot_i (T, E) int32, gate (T,),
    pos (T,) int32, keep (T,) bool, aux)``. A masked token's one-hot row is
    zero."""
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot_i = F.one_hot(expert, n_experts).to(torch.int32)
    if token_mask is not None:
        onehot_i = onehot_i * token_mask.to(torch.int32)[:, None]
    gate = torch.sum(probs * onehot_i.to(x.dtype), dim=-1)

    # 0-based position of each token in its expert's queue.
    position = (torch.cumsum(onehot_i, dim=0, dtype=torch.int32) * onehot_i
                - onehot_i)
    pos = torch.sum(position, dim=-1, dtype=torch.int32)
    keep = pos < capacity

    probs_f = probs.float()
    if token_mask is None:
        n_valid = torch.full((), onehot_i.shape[0], dtype=torch.float32,
                             device=x.device)
    else:
        valid = token_mask.float()
        probs_f = probs_f * valid[:, None]
        n_valid = torch.clamp(valid.sum(), min=1.0)
    frac = torch.sum(onehot_i, dim=0).float() / n_valid
    aux_loss = torch.mean(frac * (probs_f.sum(dim=0) / n_valid)) \
        * n_experts ** 2
    return onehot_i, gate, pos, keep, {"expert_fraction": frac,
                                       "aux_loss": aux_loss}


def top1_dispatch(x: torch.Tensor, gate_w: torch.Tensor, n_experts: int,
                  capacity: int, token_mask: Optional[torch.Tensor] = None):
    """Top-1 routing tensors for (T, D) tokens and a (D, E) gate.

    Returns ``(dispatch, combine, aux)``: the (T, E, C) one-hot
    token-to-slot routing in ``x``'s dtype, ``dispatch`` times each token's
    gate probability, and ``{"expert_fraction": (E,), "aux_loss": ()}``.
    ``token_mask`` (T,) bool, True for a real token, leaves padding out of
    the routing and the statistics."""
    onehot_i, gate, pos, keep, aux = _route(x, gate_w, n_experts, capacity,
                                            token_mask)
    # An overflow token's position is past every slot: an all-zero row.
    slot = (pos[:, None] == torch.arange(capacity, device=x.device)).to(
        x.dtype)
    dispatch = (onehot_i.to(x.dtype)[:, :, None] * slot[:, None, :]
                * keep[:, None, None])
    return dispatch, dispatch * gate[:, None, None], aux


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], capacity: int,
            ternary: bool = False, sparsity_target: float = 0.3,
            token_mask: Optional[torch.Tensor] = None):
    """Route (T, D) tokens, run each expert's GELU FFN on its slots, and
    combine. ``params``: ``gate`` (D, E), ``w1`` (E, D, H), ``w2``
    (E, H, D). Returns ``(y, aux)``; ``y`` (T, D) excludes the residual.

    Dispatch and combine are the one-hot products of :func:`top1_dispatch`
    done as a gather each way: each slot takes its token's row (an empty
    slot the zero row past the last token) and each routed token takes its
    slot's output times its gate probability. Under top-1 a slot holds at
    most one token, so the values are those of the products, bit for bit,
    and the backward's scatters add each gradient to zero (the empty slots'
    zeros aside), the same from run to run."""
    n_experts = params["gate"].shape[-1]
    t, d = x.shape
    onehot_i, gate, pos, keep, aux = _route(x, params["gate"], n_experts,
                                            capacity, token_mask)
    w1, w2 = params["w1"], params["w2"]
    if ternary:
        w1 = _ternarize_expert_planes(w1, sparsity_target)
        w2 = _ternarize_expert_planes(w2, sparsity_target)
    expert = torch.argmax(onehot_i, dim=-1)
    routed = keep & (onehot_i.sum(dim=-1) > 0)  # a masked token: no expert
    # Column ``capacity`` takes every unrouted token and is dropped.
    col = torch.where(routed, pos, capacity).long()
    slot_token = torch.full((n_experts, capacity + 1), t, dtype=torch.long,
                            device=x.device).index_put(
        (expert, col), torch.arange(t, device=x.device))
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    buf = x_pad[slot_token[:, :capacity]]                    # (E, C, D)
    h = F.gelu(torch.bmm(buf, w1), approximate="tanh")
    out = torch.bmm(h, w2)                                   # (E, C, D)
    y = out[expert, col.clamp(max=capacity - 1)] * gate[:, None]
    return torch.where(routed[:, None], y, torch.zeros_like(y)), aux
