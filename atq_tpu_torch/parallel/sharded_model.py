"""One module's state placed over a ('data', 'model') mesh, and the
gradient reduction of a data-parallel step: the runtime of parallel/mesh.py's
rules for the trainers' ``--dp``/``--tp``/``--fsdp``.

:class:`ShardedModel` reads every parameter's and buffer's spec off the JAX
layout of the module's state (utils/jax_interop.py ``jax_layout``), by
``state_specs_fsdp`` with ``fsdp`` and ``state_specs_tp`` otherwise, so
each leaf's placement is the one the JAX trainer gives it, then:

- an axis over 'model' (a quantized layer's out-features, or a scanned
  stack's stacked (L, out, in) ones) shards the module's own tensor, and
  the layer gets a ``ModelShard`` (nn/layers.py runs its tensor-parallel
  forward; the scanned stack's structure copies get it, and each layer
  runs plain, nn/transformer.py ``run_layer``);
- an axis over 'data' (``--fsdp``) keeps only this rank's block at rest
  (:attr:`optim_params` hands those blocks to the optimizer; the EMA and the
  moments live on them too). :meth:`gather` all-gathers the module's
  tensors before a forward, :meth:`release` frees them after the update
  (a buffer's block is refreshed first: BatchNorm moves its statistics in
  the forward);
- :meth:`reduce_grads`, after the backward: the sum over the ranks that
  hold the same block (a reduce-scatter over 'data' for a data-sharded
  tensor, an all-reduce otherwise; a tensor with no 'model' axis is summed
  over 'model' too), divided by their count. The loss of the whole global
  batch is computed on every rank (parallel/collectives.py), so the summed
  gradient is ``dp`` times the one-device step's, and the result is that
  gradient;
- :meth:`global_norm_sq` gives the optimizer's clip the squared norm of the
  whole gradient: each rank's blocks summed over the axes they are split
  on;
- :meth:`full_state_dict`, :meth:`to_full` and :meth:`to_local` carry
  whole tensors to and from the blocks (checkpoints are written whole, so
  ``serve``, ``evaluate`` and utils/jax_interop.py read them unchanged,
  and ``--resume`` re-shards).

On one rank with no sharded axis every method is the identity, and the step
is the one-device step bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

from atq_tpu_torch.parallel.collectives import (
    ModelShard,
    all_gather_dim,
    all_reduce_,
    reduce_scatter_dim,
)
from atq_tpu_torch.parallel.mesh import (
    DEFAULT_TP_LAYERS,
    Mesh,
    local_part,
    state_specs_fsdp,
    state_specs_tp,
)


def _collection_trees(model: nn.Module, layout):
    """The module's state as JAX-layout trees of shape-only (meta)
    tensors, ``{"params": ..., "quant": ..., ...}``."""
    sd = model.state_dict()
    trees: Dict = {}
    for key, (coll, path, perm) in layout.items():
        t = sd[key]
        shape = tuple(t.shape) if perm is None else tuple(
            t.shape[i] for i in perm)
        node = trees.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    return trees


def module_specs(model: nn.Module, dp: int, tp: int, fsdp: bool,
                 layer_names=DEFAULT_TP_LAYERS) -> Dict[str, tuple]:
    """``{state_dict key: spec}``, each spec over the port tensor's own axes
    (``()`` for a replicated one), from the JAX rules applied to the JAX
    layout of the module's state."""
    from atq_tpu_torch.utils.jax_interop import jax_layout

    layout = jax_layout(model.state_dict())
    trees = _collection_trees(model, layout)
    if fsdp:
        specs = state_specs_fsdp(trees, dp, tp, layer_names)
    elif tp > 1:
        specs = state_specs_tp(trees, tp, layer_names)
    else:
        return {key: () for key in layout}
    out = {}
    for key, (coll, path, perm) in layout.items():
        spec = specs[coll]
        for p in path:
            spec = spec[p]
        ndim = len(perm) if perm is not None else len(
            model.state_dict()[key].shape)
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        if perm is not None:  # JAX axis j is the port's axis perm[j]
            port = [None] * ndim
            for j, axis in enumerate(spec):
                port[perm[j]] = axis
            spec = tuple(port)
        out[key] = spec if any(spec) else ()
    return out


class _Entry:
    def __init__(self, name, module, attr, is_param, spec):
        self.name, self.module, self.attr = name, module, attr
        self.is_param, self.spec = is_param, spec
        self.data_dim = spec.index("data") if "data" in spec else None
        self.model_dim = spec.index("model") if "model" in spec else None
        self.block = None  # the at-rest 'data' block

    def get(self) -> torch.Tensor:
        return getattr(self.module, self.attr)

    def set(self, value: torch.Tensor) -> None:
        if self.is_param:
            self.get().data = value
        else:
            self.module._buffers[self.attr] = value


class ShardedModel:
    """``model``'s tensors placed over ``mesh`` (module docstring)."""

    def __init__(self, model: nn.Module, mesh: Mesh, fsdp: bool = False,
                 layer_names=DEFAULT_TP_LAYERS):
        self.model, self.mesh = model, mesh
        self.dp, self.tp = mesh.shape["data"], mesh.shape["model"]
        self.data_group = mesh.group("data")
        self.model_group = mesh.group("model")
        specs = module_specs(model, self.dp, self.tp, fsdp, layer_names)
        params = dict(model.named_parameters())
        self.entries: Dict[str, _Entry] = {}
        for key, spec in specs.items():
            *mod, attr = key.split(".")
            module = model.get_submodule(".".join(mod))
            self.entries[key] = _Entry(key, module, attr, key in params,
                                       spec)
        self._shard_model_axis()
        self._names = [name for name, _ in model.named_parameters()]
        for e in self.entries.values():
            if e.data_dim is not None:
                block = local_part(e.get().detach(), self._data_only(e),
                                   mesh).clone()
                e.block = nn.Parameter(block) if e.is_param else block
        self.gathered = True
        self.release()

    # ------------------------------------------------------------ setup

    def _data_only(self, e: _Entry) -> tuple:
        return tuple(a if a == "data" else None for a in e.spec)

    def _shard_model_axis(self) -> None:
        from atq_tpu_torch.nn.layers import _QuantizedLinear

        for e in self.entries.values():
            if e.model_dim is None:
                continue
            layers = self._tp_layers(e)
            if not isinstance(e.module, _QuantizedLinear) or not layers:
                raise NotImplementedError(
                    f"tensor parallelism for {e.name} (spec {e.spec}): only "
                    "a quantized linear layer's out-features shard")
            spec = tuple(a if a == "model" else None for a in e.spec)
            e.set(local_part(e.get().detach(), spec, self.mesh).clone())
            for layer in layers:
                layer.tp = ModelShard(self.model_group,
                                      self.mesh.index("model"), self.tp)

    def _tp_layers(self, e: _Entry) -> list:
        """The layers that run ``e``'s out-features shard: its own module
        (an (out, in) weight), or, for a scanned stack's stacked (L, out,
        in) weight, the stack's structure copies that each layer runs
        through."""
        if e.model_dim == 0:
            return [e.module]
        if e.model_dim != 1 or ".scan.layer." not in e.name:
            return []
        stack_path, rel = e.name.split(".scan.layer.", 1)
        stack = self.model.get_submodule(stack_path)
        rel = rel.rsplit(".", 1)[0]
        return [t.get_submodule(rel) for t in stack._templates]

    # ---------------------------------------------------------- runtime

    @property
    def optim_params(self) -> List[tuple]:
        """``(name, tensor)`` for the optimizer, aligned with
        ``model.named_parameters()``: a data-sharded parameter's block,
        otherwise the parameter."""
        out = []
        for name in self._names:
            e = self.entries.get(name)
            out.append((name, e.block if e is not None and
                        e.block is not None else e.get()))
        return out

    def _blocked(self):
        return [e for e in self.entries.values() if e.block is not None]

    def gather(self) -> None:
        """The module's tensors whole along 'data' (before a forward)."""
        if self.gathered:
            return
        for e in self._blocked():
            e.set(all_gather_dim(e.block.detach(), e.data_dim,
                                 self.data_group))
        self.gathered = True

    def release(self) -> None:
        """Back to the blocks alone (after the update): a buffer's block
        takes its part of the module's value first."""
        if not self.gathered:
            return
        for e in self._blocked():
            if not e.is_param:
                e.block.copy_(local_part(e.get(), self._data_only(e),
                                         self.mesh))
            e.set(e.block.new_empty((0,)))
        self.gathered = False

    @contextlib.contextmanager
    def whole(self):
        """The module gathered inside the block, released after it (when it
        was released before)."""
        was = self.gathered
        self.gather()
        try:
            yield
        finally:
            if not was:
                self.release()

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each optimizer tensor's ``.grad``: the step's gradient (module
        docstring). Missing gradients count as zeros."""
        if self.mesh.size == 1:
            return
        plain = []
        for name in self._names:
            e = self.entries[name]
            p = e.get()
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if e.block is not None:
                g = reduce_scatter_dim(g, e.data_dim, self.data_group)
                if e.model_dim is None:
                    all_reduce_(g, self.model_group)
                denom = self.dp * (1 if e.model_dim is not None else
                                   self.tp)
                e.block.grad = g / denom if denom > 1 else g
                p.grad = None
            else:
                p.grad = g
                plain.append(e)
        self._all_reduce_flat([e for e in plain if e.model_dim is None],
                              self.dp * self.tp, (self.data_group,
                                                  self.model_group))
        self._all_reduce_flat([e for e in plain if e.model_dim is not None],
                              self.dp, (self.data_group,))

    def _all_reduce_flat(self, entries, denom: int, groups) -> None:
        if not entries or denom == 1:
            return
        grads = [e.get().grad for e in entries]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for group in groups:
            all_reduce_(flat, group)
        flat /= denom
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def global_norm_sq(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's squared norm from the squared norms of the
        :attr:`optim_params` gradients (in that order)."""
        by_axes: Dict[tuple, List[torch.Tensor]] = {}
        for name, s in zip(self._names, sq):
            e = self.entries[name]
            axes = (e.block is not None, e.model_dim is not None)
            by_axes.setdefault(axes, []).append(s)
        total = None
        for (data, model), values in by_axes.items():
            part = torch.stack(values).sum()
            if data:
                all_reduce_(part, self.data_group)
            if model:
                all_reduce_(part, self.model_group)
            total = part if total is None else total + part
        return total

    # ---------------------------------------------------- whole tensors

    def _whole(self, e: _Entry, value: torch.Tensor) -> torch.Tensor:
        """An entry-shaped local value (block or module tensor) whole."""
        if e.block is not None and value.shape == e.block.shape:
            value = all_gather_dim(value, e.data_dim, self.data_group)
        if e.model_dim is not None:
            value = all_gather_dim(value, e.model_dim, self.model_group)
        return value

    def _local(self, e: _Entry, value: torch.Tensor) -> torch.Tensor:
        """A whole value's part for this rank: the block's for a
        data-sharded entry, else the module tensor's."""
        spec = e.spec if e.block is not None else tuple(
            a if a == "model" else None for a in e.spec)
        return local_part(value, spec, self.mesh)

    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` with every tensor whole (a collective:
        every rank calls it)."""
        out = {}
        for key, value in self.model.state_dict().items():
            e = self.entries.get(key)
            if e is None or not e.spec:
                out[key] = value
            else:
                out[key] = self._whole(e, e.block if e.block is not None
                                       and not self.gathered
                                       else value).detach()
        return out

    @torch.no_grad()
    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Whole tensors into the blocks and the module (re-sharding)."""
        for key, value in state.items():
            e = self.entries.get(key)
            if e is None or not e.spec:
                target = self.model.state_dict()[key]
                # As load_state_dict, a one-element value fills a 0-d one.
                target.copy_(value.reshape(target.shape))
                continue
            value = value.to(e.get().device if e.block is None
                             else e.block.device)
            if e.block is not None:
                e.block.copy_(self._local(e, value))
                if self.gathered:
                    e.get().copy_(local_part(value, tuple(
                        a if a == "model" else None for a in e.spec),
                        self.mesh))
            else:
                e.get().copy_(self._local(e, value))

    def to_full(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Values aligned with :attr:`optim_params` (moments, the EMA),
        whole (a collective)."""
        return [self._whole(self.entries[n], v) if self.entries[n].spec
                else v for n, v in zip(self._names, values)]

    def to_module(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Values aligned with :attr:`optim_params` in the module's shapes
        (the blocks gathered along 'data'; a collective)."""
        return [all_gather_dim(v, self.entries[n].data_dim, self.data_group)
                if self.entries[n].block is not None else v
                for n, v in zip(self._names, values)]

    def to_local(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole values aligned with ``model.named_parameters()`` as this
        rank's parts, aligned with :attr:`optim_params`."""
        return [self._local(self.entries[n], v).clone()
                if self.entries[n].spec else v
                for n, v in zip(self._names, values)]

    def state_bytes(self) -> int:
        """Bytes of the module's state this rank keeps at rest."""
        total = 0
        for key, value in self.model.state_dict().items():
            e = self.entries.get(key)
            t = e.block if e is not None and e.block is not None else value
            total += t.numel() * t.element_size()
        return total
