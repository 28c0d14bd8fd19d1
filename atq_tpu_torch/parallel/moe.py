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

- **Expert parallelism** (:func:`moe_ffn_sharded`): the experts split over
  an ``expert`` process group, the tokens too, one ``all_to_all_single``
  each way (atq_tpu/parallel/moe.py:150-200), capacity per shard and the
  statistics averaged over the group; differentiable.
- Inside a data-parallel step the dense :func:`moe_ffn` routes over the
  global token set (:func:`_route`), as JAX's GSPMD step does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from atq_tpu_torch.core.quantize import adaptive_ternary_quantization_batched
from atq_tpu_torch.parallel.collectives import (
    active_data_shard,
    all_gather_dim,
    all_reduce_,
    all_reduce_sum,
    group_size,
)


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


def _route(x, gate_w, n_experts: int, capacity: int, token_mask,
           local: bool = False):
    """Top-1 routing of (T, D) tokens: ``(onehot_i (T, E) int32, gate (T,),
    pos (T,) int32, keep (T,) bool, aux)``. A masked token's one-hot row is
    zero.

    Inside a data-parallel step (parallel/collectives.py ``data_shard``),
    unless ``local``, the tokens are one rank's block of the global token
    set, as JAX routes them under GSPMD: a token's slot counts the tokens
    of the ranks before it (an exclusive scan of the per-expert counts over
    the data group), and the statistics are the global batch's (their sums
    all-reduced)."""
    shard = None if local else active_data_shard()
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
    counts = torch.sum(onehot_i, dim=0, dtype=torch.int32)
    if shard is not None:
        ranks = all_gather_dim(counts[None], 0, shard.group)   # (n, E)
        position = position + ranks[:shard.index].sum(
            dim=0, dtype=torch.int32)[None, :] * onehot_i
        counts = ranks.sum(dim=0, dtype=torch.int32)
    pos = torch.sum(position, dim=-1, dtype=torch.int32)
    keep = pos < capacity

    probs_f = probs.float()
    if token_mask is None:
        n_valid = torch.full((), onehot_i.shape[0], dtype=torch.float32,
                             device=x.device)
    else:
        valid = token_mask.float()
        probs_f = probs_f * valid[:, None]
        n_valid = valid.sum()
    prob_sums = probs_f.sum(dim=0)
    if shard is not None:
        n_valid = all_reduce_(n_valid.clone(), shard.group)
        prob_sums = all_reduce_sum(prob_sums, shard.group)
    if token_mask is not None:
        n_valid = torch.clamp(n_valid, min=1.0)
    frac = counts.float() / n_valid
    aux_loss = torch.mean(frac * (prob_sums / n_valid)) * n_experts ** 2
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


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` on equal dim-0 blocks: block j goes to rank j,
    block i of the output came from rank i. The pattern is its own
    transpose, so the backward sends the gradient's blocks back alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_ffn_sharded(x: torch.Tensor, params: Dict[str, torch.Tensor], group,
                    capacity: int, ternary: bool = False,
                    sparsity_target: float = 0.3,
                    token_mask: Optional[torch.Tensor] = None):
    """Expert-parallel MoE FFN over the process ``group`` of n ranks (the
    mesh's ``expert`` axis in JAX): ``x`` (T, D) is this rank's token shard,
    ``params["w1"]``/``["w2"]`` its E/n experts' planes (rank i holds
    experts [i·E/n, (i+1)·E/n)), the gate (D, E) whole. ``capacity`` is per
    shard per expert. Each rank routes its tokens into (E, C, D) slots as
    :func:`top1_dispatch` does (its own cumsum), one all-to-all sends each
    expert's slots to its rank ((E/n, n·C, D)), the local experts run, and
    the reverse all-to-all brings the outputs home for the combine. The aux
    statistics are averaged over the group. Returns ``(y, aux)``; the math
    of a rank is :func:`moe_ffn`'s on its token shard."""
    n = group_size(group)
    n_experts = params["gate"].shape[-1]
    if n_experts % n:
        raise ValueError(f"n_experts={n_experts} not divisible by the "
                         f"expert group's size {n}")
    onehot_i, gate, pos, keep, aux = _route(x, params["gate"], n_experts,
                                            capacity, token_mask, local=True)
    slot = (pos[:, None] == torch.arange(capacity, device=x.device)).to(
        x.dtype)
    dispatch = (onehot_i.to(x.dtype)[:, :, None] * slot[:, None, :]
                * keep[:, None, None])
    combine = dispatch * gate[:, None, None]
    w1, w2 = params["w1"], params["w2"]
    if ternary:
        w1 = _ternarize_expert_planes(w1, sparsity_target)
        w2 = _ternarize_expert_planes(w2, sparsity_target)
    buf = torch.einsum("tec,td->ecd", dispatch, x)          # (E, C, D)
    local_e, d = n_experts // n, x.shape[-1]
    if n > 1:  # token-major -> expert-major: (E/n, n·C, D)
        buf = _AllToAll.apply(buf, group).reshape(n, local_e, capacity, d)
        buf = buf.transpose(0, 1).reshape(local_e, n * capacity, d)
    h = F.gelu(torch.einsum("ecd,edh->ech", buf, w1), approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, w2)
    if n > 1:  # expert-major -> token-major: (E, C, D)
        out = out.reshape(local_e, n, capacity, d).transpose(0, 1)
        out = _AllToAll.apply(out, group).reshape(n_experts, capacity, d)
    y = torch.einsum("tec,ecd->td", combine, out)
    aux = {k: all_reduce_sum(v, group) / n for k, v in aux.items()}
    return y, aux
