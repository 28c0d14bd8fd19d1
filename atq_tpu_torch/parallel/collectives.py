"""Collectives over ``torch.distributed`` process groups (port of
atq_tpu/parallel/collectives.py), and the shard contexts the sharded steps
run under.

The JAX package runs one process and lets GSPMD place the collectives; the
port runs one process a device (torchrun) and calls them itself, so that a
step over the ('data', 'model') mesh computes what the one-device step
computes on the global batch:

- :func:`all_gather_embeddings` gathers each rank's embedding rows into the
  global batch, the contrastive loss's negative pool. Its backward is the
  true adjoint: the gathered gradient summed over the ranks, each rank
  keeping its rows. Every rank computes the loss of the whole pool, so the
  ranks' gradients add up to ``dp`` times the loss's: the trainers divide
  the summed gradients by ``dp`` (parallel/sharded_model.py).
  :func:`all_reduce_sum`, which BatchNorm's and the MoE router's global
  statistics go through, keeps the same convention.
- :func:`data_shard` marks the step's forward as one rank's rows of a
  global batch of ``count`` such parts. Inside it :func:`rand_rows` draws
  every per-row random value (dropout masks, flips, rotations) for the
  global batch from the shared generator and keeps this rank's rows, so the
  draws are those of the one-device step; BatchNorm normalizes with the
  global batch's statistics and the MoE router counts capacity over the
  global token set.
- A quantized layer under tensor parallelism holds an out-features shard
  (:class:`ModelShard`): :func:`copy_to_model` (identity, backward summed
  over the 'model' group) carries its input and its whole-layer scalars,
  :func:`gather_features` its output (gathered along features, backward
  the rank's slice), as Megatron's column-parallel layer does.

With no group (one process, or an axis of size 1) every function is the
identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    parts = out.view((n,) + tuple(x.shape)).unbind(0)
    return torch.cat(parts, dim=dim) if dim else out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``x``, this rank's part of it along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    parts = torch.stack(torch.chunk(x, n, dim=dim)).contiguous()
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.view((-1,) + tuple(out.shape[1:])),
                               group=group)
    return out


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group in place."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, y.shape[dim]
        return all_gather_dim(y, dim, group)

    @staticmethod
    def backward(ctx, g):
        index = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, index * ctx.width,
                        ctx.width).contiguous(), None, None


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_replicated(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``y`` concatenated along ``dim``, for a result that every
    rank then uses alike (its loss computed on each rank once): the
    backward keeps this rank's slice of the gradient, not the sum."""
    if group_size(group) == 1:
        return y
    return _GatherReplicated.apply(y, dim % y.ndim, group)


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` for a result every rank then uses alike:
    the backward passes the gradient through unchanged."""
    if group_size(group) == 1:
        return x
    return _AllReduceReplicated.apply(x, group)


class _RingShift(torch.autograd.Function):
    """Send to the next rank of the group, receive from the previous one;
    the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return ring_exchange(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return ring_exchange(g, ctx.group, -ctx.step), None, None


def ring_exchange(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """This rank's ``x`` sent ``step`` places along the group's ring; the
    result is what the rank ``step`` places before sent (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """:func:`ring_exchange`, differentiable (``jax.lax.ppermute`` over a
    ring)."""
    if group_size(group) == 1:
        return x
    return _RingShift.apply(x, group, step)


def all_gather_embeddings(embeddings: torch.Tensor, group=None):
    """Each rank's (B, D) rows gathered into the (count·B, D) global batch,
    in rank order; differentiable (the backward sums over the ranks)."""
    if group_size(group) == 1:
        return embeddings
    return _AllGather.apply(embeddings, 0, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of ``x``; differentiable (the backward is the sum of
    the gradients, every rank's output depending on every input)."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def psum_grads(grads, group=None):
    """Sum a list (or dict) of gradient tensors over the group, in place."""
    values = grads.values() if isinstance(grads, dict) else grads
    for g in values:
        if g is not None:
            all_reduce_(g, group)
    return grads


def pmean_metrics(metrics: dict, group=None) -> dict:
    """The group's mean of each metric tensor (a new dict)."""
    n = group_size(group)
    return {k: all_reduce_(torch.as_tensor(v).float().clone(), group) / n
            for k, v in metrics.items()}


def global_contrastive_similarity(image_embeddings, text_embeddings,
                                  temperature, group=None):
    """Local embedding rows -> the global similarity matrix, the same on
    every rank: one differentiable gather per modality."""
    img = all_gather_embeddings(image_embeddings, group)
    txt = all_gather_embeddings(text_embeddings, group)
    return torch.matmul(img, txt.T) / temperature


# ------------------------------------------------------------ data shards


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's part ``index`` of ``count`` equal row blocks of a
    global batch, over the 'data' ``group``."""

    group: Optional[object]
    index: int
    count: int


_DATA_SHARD: Optional[DataShard] = None


@contextlib.contextmanager
def data_shard(group, index: int, count: int):
    """Run the block as rank ``index`` of ``count`` over a global batch
    (module docstring). With ``count`` 1 nothing changes."""
    global _DATA_SHARD
    saved = _DATA_SHARD
    _DATA_SHARD = DataShard(group, index, count) if count > 1 else None
    try:
        yield
    finally:
        _DATA_SHARD = saved


def active_data_shard() -> Optional[DataShard]:
    return _DATA_SHARD


def shard_rows(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rows ``[index·n, (index+1)·n)`` of ``x``, ``n = len(x) / count``."""
    if count == 1:
        return x
    if x.shape[0] % count:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{count} equal parts")
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def rand_rows(shape, generator: Optional[torch.Generator], device):
    """``torch.rand(shape)`` for one rank's rows: inside :func:`data_shard`
    the draw is the global batch's (``count · shape[0]`` rows, the one-device
    step's draw) and this rank keeps its block."""
    shard = _DATA_SHARD
    if shard is None:
        return torch.rand(shape, generator=generator, device=device)
    shape = tuple(shape)
    full = torch.rand((shape[0] * shard.count,) + shape[1:],
                      generator=generator, device=device)
    return shard_rows(full, shard.index, shard.count)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Inside :func:`data_shard`, the sum of ``x`` over the data group
    (differentiable); otherwise ``x``."""
    shard = _DATA_SHARD
    return x if shard is None else all_reduce_sum(x, shard.group)


# ----------------------------------------------------------- model shards


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A layer's out-features shard ``index`` of ``count`` over the
    'model' ``group``."""

    group: object
    index: int
    count: int


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Identity; the backward sums the gradient over the 'model' group
    (the input of a column-parallel layer, its whole-layer scalars)."""
    return _CopyToGroup.apply(x, shard.group)


def gather_features(y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The shards' outputs concatenated along the last axis; the backward
    keeps this rank's slice."""
    return gather_replicated(y, -1, shard.group)


def gather_model_rows(x: torch.Tensor, shard: ModelShard,
                      dim: int = 0) -> torch.Tensor:
    """The whole tensor from its out-features shards along ``dim`` (0 for
    a layer's (out, in) weight, 1 for a scanned stack's (L, out, in)), no
    gradient."""
    return all_gather_dim(x.detach(), dim, shard.group)


def gather_model_shards(x: torch.Tensor, shard: ModelShard,
                        dim: int = 0) -> torch.Tensor:
    """:func:`gather_model_rows` with the gather's true adjoint as its
    backward: the whole gradient summed over the 'model' group, each rank
    keeping its own shard."""
    return _AllGather.apply(x, dim, shard.group)
