"""Per-process input for a data-parallel run (port of
atq_tpu/parallel/multihost.py).

Each rank loads only the rows its device owns (:func:`process_batch_slice`)
and :func:`global_batch_from_local` assembles the global batch from the
ranks' rows when a step needs all of it. With one process both are the
identity's counterparts: the whole batch, unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from atq_tpu_torch.parallel.collectives import all_gather_dim
from atq_tpu_torch.parallel.mesh import Mesh, world_rank, world_size


def process_batch_slice(global_batch_size: int,
                        mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """``[start, end)``: the rows of the global batch this rank loads, its
    block by rank (or by its index on the mesh's 'data' axis when ``mesh``
    is given, so the ranks of one model group load the same rows). Raises
    when the batch does not divide evenly: an uneven split would skew the
    contrastive negative pool."""
    if mesh is None:
        n, index = world_size(), world_rank()
    else:
        n, index = mesh.shape["data"], mesh.index("data")
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by process count {n}")
    per = global_batch_size // n
    return index * per, (index + 1) * per


def global_batch_from_local(local_batch, mesh: Mesh, axis: str = "data"):
    """The global batch (every rank's rows along the leading axis, in rank
    order over ``axis``) from this rank's ``local_batch``: a tuple, list or
    dict of tensors, or one tensor."""
    group = mesh.group(axis)

    def gather(x):
        return all_gather_dim(torch.as_tensor(x), 0, group)

    if isinstance(local_batch, dict):
        return {k: gather(v) for k, v in local_batch.items()}
    if isinstance(local_batch, (list, tuple)):
        return type(local_batch)(gather(v) for v in local_batch)
    return gather(local_batch)
