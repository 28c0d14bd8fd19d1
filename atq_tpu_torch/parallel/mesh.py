"""The ('data', 'model') mesh over ``torch.distributed`` and the JAX
package's placement rules (port of atq_tpu/parallel/mesh.py).

JAX runs one process and places arrays with ``NamedSharding``s; the port
runs one process a device (``torchrun --nproc_per_node N``) and each rank
holds its own part of every tensor. The rules are the JAX ones, as pure
functions of a leaf's path and shape that return the same specs,
``PartitionSpec``s written as tuples (``()`` replicated, ``("model",
None)`` the out-features axis over 'model', ...):

- :func:`tp_spec`: the 2-D ``weight`` and ``precision_mask`` of the layers
  named in ``DEFAULT_TP_LAYERS`` (the classifier passes its
  ``("classifier_0", "classifier_3")``) shard their out-features axis over
  'model' when ``tp`` divides it; a scanned stack's (L, out, in) its
  second axis.
- :func:`fsdp_spec`: a leaf of at least ``min_size`` (16,384) elements
  shards its largest dp-divisible free axis over 'data' (the first of
  equal ones); it composes with a tensor-parallel spec.
- :func:`state_specs_fsdp` and :func:`state_specs_tp` apply them to a
  training-state dict as ``shard_state_fsdp``/``shard_state_tp`` place it:
  the parameter collections by path, every other leaf (optimizer moments,
  BatchNorm statistics) by shape match against the sharded parameters.

:func:`shard_tree_tp`, :func:`shard_state_tp` and :func:`shard_state_fsdp`
take this rank's part of every tensor leaf by those specs. The trainers
place their modules through parallel/sharded_model.py, which reads the
specs off the JAX layout of the module's state (utils/jax_interop.py).

:func:`init_distributed` starts the process group from torchrun's
environment: NCCL for the GPU (``cuda:LOCAL_RANK``), gloo for the CPU. The
backend follows the device. :func:`make_mesh` lays the world out row-major
as JAX's ``devices.reshape(dp, tp)``: rank = data index · tp + model
index.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from atq_tpu_torch.parallel.collectives import (
    all_gather_embeddings,
    data_shard,
    shard_rows,
)

DEFAULT_TP_LAYERS = (
    "linear1", "linear2",
    "q_proj", "k_proj", "v_proj", "out_proj",
    "projector", "image_projector", "text_projector", "final_fusion",
)
AXES = ("data", "model")


def init_distributed(device=None) -> int:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL when
    ``device`` is a CUDA device, gloo otherwise. A no-op for one process
    (no ``WORLD_SIZE``, or 1) and when a group is already up. Returns the
    world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    cuda = device is not None and torch.device(device).type == "cuda"
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method="env://")
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (nothing with one process)."""
    if world_size() > 1:
        dist.barrier()


def from_rank0(obj):
    """Rank 0's ``obj`` on every rank (a picklable value): decisions such as
    the best checkpoint's are taken once, so that every rank makes the same
    collective calls after them."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Mesh:
    """The ranks as a (dp, tp) grid with axes ('data', 'model').

    ``shape`` maps each axis to its size, as a JAX mesh's does;
    ``group(axis)`` is the process group of the ranks that differ only
    along ``axis`` (None for an axis of size 1), ``index(axis)`` this rank's
    coordinate."""

    def __init__(self, dp: int, tp: int, device_mesh=None):
        self.shape = {"data": dp, "model": tp}
        self.device_mesh = device_mesh

    def group(self, axis: str):
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor."""
        return shard_rows(x, self.index("data"), self.shape["data"])

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's rows of ``x`` in rank order (differentiable)."""
        return all_gather_embeddings(x, self.group("data"))

    def data_shard(self):
        """The context of a step over this rank's rows (collectives.py
        ``data_shard``)."""
        return data_shard(self.group("data"), self.index("data"),
                          self.shape["data"])


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ('data', 'model') mesh over the process group's ranks (one rank
    without a group). ``dp`` defaults to world // tp; dp · tp must be the
    world size, as in JAX (ValueError otherwise)."""
    n = world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    if n == 1:
        return Mesh(dp, tp)
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(dp, tp, init_device_mesh(kind, (dp, tp),
                                         mesh_dim_names=AXES))


def training_mesh(dp: Optional[int], tp: int, device) -> Mesh:
    """The trainers' mesh: the process group from torchrun's environment
    (:func:`init_distributed`), then :func:`make_mesh`. One process asked
    for more than one rank raises, naming torchrun: it never runs a
    multi-rank step alone."""
    world = init_distributed(device)
    want = (dp or 1) * tp if dp is not None or tp > 1 else 1
    if world == 1 and want > 1:
        raise ValueError(
            f"--dp {dp} --tp {tp} needs {want} processes, one a device: "
            f"launch with torchrun --nproc_per_node {want} -m <trainer> "
            "(--device cpu runs them over gloo)")
    return make_mesh(dp, tp)


def data_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """The spec of a batch: its leading axis over 'data'."""
    del mesh
    return ("data",) + (None,) * (ndim - 1)


def _map(tree, fn, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (named tuples too), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(path, tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every tensor of a batch (its leading axis split
    over 'data')."""
    return _map(batch, lambda _, x: shard_rows(
        x, mesh.index("data"), mesh.shape["data"]))


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` made the same on all ranks: a broadcast from
    rank 0, in place. Returns the tree."""
    del mesh

    def bcast(_, x):
        if isinstance(x, torch.Tensor) and world_size() > 1:
            dist.broadcast(x, src=0)
        return x

    return _map(tree, bcast)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()) or ())


def tp_spec(path_keys, leaf, tp: int,
            layer_names=DEFAULT_TP_LAYERS) -> tuple:
    """The tensor-parallel spec of one param/quant leaf (JAX
    ``tp_spec``)."""
    keys = [str(k) for k in path_keys]
    if (tp > 1 and keys and keys[-1] in ("weight", "precision_mask")
            and any(nm in keys for nm in layer_names)):
        shape = _shape(leaf)
        if len(shape) == 2 and shape[0] % tp == 0:
            return ("model", None)
        if len(shape) == 3 and "scan" in keys and shape[1] % tp == 0:
            return (None, "model", None)
    return ()


def fsdp_spec(leaf, dp: int, min_size: int = 16384,
              existing: Optional[tuple] = None) -> tuple:
    """The ZeRO-3 spec of one state leaf (JAX ``fsdp_spec``): the largest
    dp-divisible free axis of a leaf of ``min_size`` elements or more
    shards over 'data'; ``existing`` (a tensor-parallel spec) keeps its
    axes."""
    shape = _shape(leaf)
    base = tuple(existing) if existing is not None else ()
    if dp <= 1 or not shape or int(np.prod(shape)) < min_size:
        return base
    taken = base + (None,) * (len(shape) - len(base))
    best = -1
    for i, d in enumerate(shape):
        if taken[i] is None and d % dp == 0 and (
                best < 0 or d > shape[best]):
            best = i
    if best < 0:
        return base
    spec = list(taken)
    spec[best] = "data"
    return tuple(spec)


def tree_specs_tp(tree, tp: int, layer_names=DEFAULT_TP_LAYERS):
    """``(specs, sharded_shapes)``: :func:`tp_spec` of every leaf of a
    params-like tree, and the shapes of the leaves it shards."""
    shapes = set()

    def spec(path, leaf):
        s = tp_spec(path, leaf, tp, layer_names)
        if s:
            shapes.add(_shape(leaf))
        return s

    return _map(tree, spec), shapes


PARAM_KEYS = ("params", "quant", "ema_params")


def state_specs_tp(state: dict, tp: int, layer_names=DEFAULT_TP_LAYERS,
                   param_keys=PARAM_KEYS) -> dict:
    """The specs ``shard_state_tp`` gives a training-state dict: the
    ``param_keys`` trees by path, every other leaf by shape (a 2-D leaf of
    a sharded parameter's shape on its first axis, a 3-D one on its
    second)."""
    out, shapes = {}, set()
    for key in param_keys:
        if key in state:
            out[key], s = tree_specs_tp(state[key], tp, layer_names)
            shapes |= s

    def by_shape(_, leaf):
        shape = _shape(leaf)
        if len(shape) == 2 and shape in shapes:
            return ("model", None)
        if len(shape) == 3 and shape in shapes:
            return (None, "model", None)
        return ()

    for key, value in state.items():
        if key not in out:
            out[key] = _map(value, by_shape)
    return out


def state_specs_fsdp(state: dict, dp: int, tp: int = 1,
                     layer_names=DEFAULT_TP_LAYERS, min_size: int = 16384,
                     param_keys=PARAM_KEYS) -> dict:
    """The specs ``shard_state_fsdp`` gives a training-state dict: with
    ``tp`` 1, :func:`fsdp_spec` of every leaf; otherwise the ``param_keys``
    trees by :func:`tp_spec` composed with :func:`fsdp_spec`, and every other
    leaf by shape match against them (the first parameter of a shape wins),
    else by :func:`fsdp_spec`."""
    if tp <= 1:
        return _map(state, lambda _, leaf: fsdp_spec(leaf, dp, min_size))
    shape_spec = {}

    def param(path, leaf):
        base = tp_spec(path, leaf, tp, layer_names)
        spec = fsdp_spec(leaf, dp, min_size, existing=base or None)
        if spec:
            shape_spec.setdefault(_shape(leaf), spec)
        return spec

    out = {key: _map(state[key], param) for key in param_keys
           if key in state}

    def by_shape(_, leaf):
        spec = shape_spec.get(_shape(leaf))
        return spec if spec is not None else fsdp_spec(leaf, dp, min_size)

    for key, value in state.items():
        if key not in out:
            out[key] = _map(value, by_shape)
    return out


def local_part(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each named axis split
    evenly over its mesh axis."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = x.shape[dim] // mesh.shape[axis]
            x = x.narrow(dim, mesh.index(axis) * n, n)
    return x


def _place(tree, specs, mesh: Mesh):
    """``tree`` with each tensor leaf replaced by its part under the spec at
    the same place of ``specs`` (the data tree drives the walk)."""
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_place(v, s, mesh) for v, s in zip(tree, specs)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    if isinstance(tree, torch.Tensor) and specs:
        return local_part(tree, specs, mesh).clone()
    return tree


def shard_tree_tp(tree, mesh: Mesh, tp: int, layer_names=DEFAULT_TP_LAYERS):
    """``(local_tree, sharded_shapes)``: this rank's part of every tensor of
    a params-like tree by :func:`tp_spec`."""
    specs, shapes = tree_specs_tp(tree, tp, layer_names)
    return _place(tree, specs, mesh), shapes


def shard_state_tp(state: dict, mesh: Mesh, tp: int,
                   layer_names=DEFAULT_TP_LAYERS,
                   param_keys=PARAM_KEYS) -> dict:
    """This rank's part of a training-state dict by
    :func:`state_specs_tp`."""
    return _place(state, state_specs_tp(state, tp, layer_names, param_keys),
                  mesh)


def shard_state_fsdp(state: dict, mesh: Mesh, *, tp: int = 1,
                     layer_names=DEFAULT_TP_LAYERS, min_size: int = 16384,
                     param_keys=PARAM_KEYS) -> dict:
    """This rank's part of a training-state dict by
    :func:`state_specs_fsdp` (dp is the mesh's 'data' size)."""
    specs = state_specs_fsdp(state, mesh.shape["data"], tp, layer_names,
                             min_size, param_keys)
    return _place(state, specs, mesh)
