"""Pipeline parallelism: a GPipe schedule of microbatches over a process
group (port of atq_tpu/parallel/pipeline.py).

Rank s of the ``pipe`` group owns stage s's parameters (its slice of the
stacked ``stage_params``). The schedule runs ``n_micro + n_stages − 1``
ticks: on each, every stage applies ``stage_fn`` to the activation it
holds (stage 0 takes the next microbatch), the last stage banks its output
for the microbatch that entered ``n_stages − 1`` ticks before, and the
activations move one stage on round the ring (one point-to-point exchange,
``batch_isend_irecv``). Bubble fraction ``(n_stages − 1) / (n_micro +
n_stages − 1)``. The exchanges are differentiable, so the schedule trains:
the backward sends each activation's gradient one stage back per tick.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from atq_tpu_torch.parallel.collectives import (
    all_reduce_replicated,
    group_size,
    ring_shift,
)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def split_microbatches(batch, n_micro: int):
    """Every leaf's leading batch axis (B, ...) -> (n_micro, B / n_micro,
    ...); a batch that ``n_micro`` does not divide raises."""
    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    return _map(batch, split)


def merge_microbatches(batch):
    """Inverse of :func:`split_microbatches`."""
    return _map(batch, lambda x: x.reshape(x.shape[0] * x.shape[1],
                                           *x.shape[2:]))


def stack_stage_params(param_list):
    """Per-stage parameter trees stacked on a new leading (stage) axis."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in param_list])
                for k in first}
    return torch.stack(list(param_list))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params, x: torch.Tensor, *, group,
                   n_micro: int) -> torch.Tensor:
    """``x`` (B, ...), the same on every rank, through the group's
    ``n_stages`` stages in order: ``stage_fn(params_of_one_stage,
    activation)`` on each, with one fixed activation shape. ``stage_params``
    is stacked on a leading stage axis (:func:`stack_stage_params`); rank s
    uses slice s. Returns the last stage's (B, ...) output on every rank
    (the backward reaches each rank's own stage)."""
    n_stages = group_size(group)
    stage = torch.distributed.get_rank(group) if n_stages > 1 else 0
    params = _map(stage_params, lambda p: p[stage])
    xs = split_microbatches(x, n_micro)
    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    # Every received activation joins the result times 0, so that each
    # rank's backward runs every exchange and its sent activations get
    # their gradients from the next stage (stage 0 uses none it receives).
    anchor = 0.0
    for t in range(n_micro + n_stages - 1):
        inp = xs[min(t, n_micro - 1)] if stage == 0 else buf
        out = stage_fn(params, inp)
        slot = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= slot < n_micro:
            outs[slot] = out
        if t + 1 < n_micro + n_stages - 1:
            buf = ring_shift(out, group)
            anchor = anchor + 0.0 * buf.sum()
    # The last stage's outputs, on every rank (the others hold zeros).
    return all_reduce_replicated(merge_microbatches(torch.stack(outs)),
                                 group) + anchor
