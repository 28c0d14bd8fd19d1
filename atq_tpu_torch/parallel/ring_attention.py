"""Ring attention: attention with the sequence sharded over a process group
(port of atq_tpu/parallel/ring_attention.py).

Each rank holds a block of the sequence: its queries stay, and the key and
value blocks (with their padding mask) pass once round the ring, one
point-to-point exchange a step (``batch_isend_irecv``), while each rank
keeps an online softmax over the blocks it has seen (running max and
denominator, flash-attention style). N ranks, N blocks. It is plain torch
ops, as the JAX function is plain ``jnp``: no Pallas kernel of atq_tpu
backs it, and the exchanges are differentiable (the backward sends the
gradients back round the ring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from atq_tpu_torch.parallel.collectives import (
    gather_replicated,
    group_size,
    ring_shift,
    shard_rows,
)

NEG_INF = -1e30


def ring_attention(q, k, v, group, key_padding_mask: Optional[torch.Tensor]
                   = None, scale: Optional[float] = None) -> torch.Tensor:
    """This rank's (B, H, L_local, D) output: softmax attention of its
    query block over the whole sequence (the concatenation of the ranks'
    blocks in rank order). ``key_padding_mask``: this rank's (B, L_local)
    block, True = pad. Equal to :func:`dense_reference_attention` on the
    gathered sequence up to float reassociation."""
    n = group_size(group)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    b, h, lq, _ = q.shape
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                         device=q.device)
    row_sum = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one exchange a step carries both
    # Sent as uint8: not every backend carries bool tensors.
    mask_blk = (None if key_padding_mask is None
                else key_padding_mask.to(torch.uint8))
    for step in range(n):
        k_blk, v_blk = kv[0], kv[1]
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              k_blk.float()) * scale
        if mask_blk is not None:
            scores = scores.masked_fill(mask_blk.bool()[:, None, None, :],
                                        NEG_INF)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        row_sum = row_sum * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_blk.float())
        row_max = new_max
        if step + 1 < n:
            kv = ring_shift(kv, group)
            if mask_blk is not None:
                mask_blk = ring_shift(mask_blk, group)
    return (o / torch.clamp(row_sum, min=1e-30)[..., None]).to(q.dtype)


def dense_reference_attention(q, k, v, key_padding_mask=None, scale=None):
    """Plain softmax attention (the one-device oracle)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def sequence_parallel_attention(q, k, v, group, key_padding_mask=None,
                                scale=None):
    """Whole (B, H, L, D) tensors, the same on every rank, in; the whole
    output out. Each rank takes its block of the sequence (L divided over
    the group), runs :func:`ring_attention`, and the blocks are gathered
    back (the backward keeps each rank's block of the gradient)."""
    n, me = group_size(group), (torch.distributed.get_rank(group)
                                if group_size(group) > 1 else 0)

    def block(t, dim):
        return shard_rows(t.transpose(0, dim), me, n).transpose(0, dim)

    mask = None if key_padding_mask is None else block(key_padding_mask, 1)
    out = ring_attention(block(q, 2), block(k, 2), block(v, 2), group, mask,
                         scale)
    return gather_replicated(out, 2, group)
