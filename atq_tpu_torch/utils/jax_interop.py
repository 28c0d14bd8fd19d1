"""Carry weights between the JAX package's checkpoints and the port.

The JAX trainers write a flat ``.npz`` whose keys are '/'-joined paths of a
nested dict (atq_tpu/train/classifier.py:_save_checkpoint), typically
``{"params": ..., "quant": ..., "batch_stats": ...}``. This module reads
and writes that layout with numpy alone and maps it to and from a port
module's ``state_dict``:

- conv ``kernel`` (H, W, I, O) <-> ``weight`` (O, I, H, W); a 2-D flax
  Dense ``kernel`` (in, out) <-> ``weight`` (out, in);
- BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``;
- ``quant/<layer>/precision_mask`` and ``sparsity_target`` <-> buffers;
- quantized layers' ``weight`` (out, in), ``alpha``, ``bias``, ``wp``,
  ``wn`` pass through under the same names;
- LayerNorm ``scale`` <-> ``weight``; flax ``Embed`` ``embedding`` <->
  ``weight`` of a module named ``embedding`` or whose name starts with
  ``Embed`` (flax's auto-name ``Embed_0``);
- the 'constants' collection (the text encoder's ``positional_encoding``)
  <-> buffers of the same name;
- the scanned stack's layout ``<stack>/scan/layer/...`` passes through with
  its leading layer axis (2-D kernels there would transpose their last two
  axes), and the stacked bool ``precision_mask`` and (L,)
  ``sparsity_target`` quant leaves map to buffers of the same shapes.

With it a checkpoint written by ``train.py`` serves on the port unchanged,
a checkpoint written by the port's trainer serves on the JAX package, and
tests feed both packages one init. :func:`from_jax_train_state` and
:func:`to_jax_train_state` carry the classifier trainer's pair of models
(the ATQ student and the full-precision teacher, whose flax ``Dense``
kernels are transposed like any 2-D kernel).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_QUANT = ("precision_mask", "sparsity_target")
_BN_PARAMS_INV = {v: k for k, v in _BN_PARAMS.items()}
_BN_STATS_INV = {v: k for k, v in _BN_STATS.items()}


def load_checkpoint(path: str) -> Dict:
    """Nested dict of numpy arrays from a flat '/'-keyed ``.npz``."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def save_checkpoint(tree: Dict, path: str) -> None:
    """Write a nested dict of arrays as a flat '/'-keyed ``.npz``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, name)
            elif v is not None:
                flat[name] = (v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v))

    walk(tree, "")
    np.savez(path, **flat)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, node


_CONSTANTS = ("positional_encoding",)


def from_jax_variables(tree: Dict) -> Dict[str, torch.Tensor]:
    """A port ``state_dict`` from JAX variables (``params``, ``quant``,
    ``batch_stats`` and ``constants`` collections of numpy arrays)."""
    sd: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for path, leaf in _leaves(tree.get("batch_stats", {})):
        *mod, name = path
        if name not in _BN_STATS:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[".".join(mod + [_BN_STATS[name]])] = torch.tensor(
            np.asarray(leaf, np.float32))
        bn_modules.add(tuple(mod))
    for mod in bn_modules:
        sd[".".join(list(mod) + ["num_batches_tracked"])] = torch.tensor(
            0, dtype=torch.long)
    for path, leaf in _leaves(tree.get("params", {})):
        *mod, name = path
        a = np.asarray(leaf)
        if tuple(mod) in bn_modules:
            if name not in _BN_PARAMS:
                raise KeyError(f"unexpected BatchNorm param {'/'.join(path)}")
            name = _BN_PARAMS[name]
        elif name in ("scale", "embedding"):  # LayerNorm, Embed
            name = "weight"
        elif name == "kernel":
            name = "weight"
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T  # (in, out) -> (out, in)
            else:
                raise ValueError(f"kernel {'/'.join(path)} of shape "
                                 f"{a.shape}")
        sd[".".join(mod + [name])] = torch.tensor(np.ascontiguousarray(a))
    for path, leaf in _leaves(tree.get("quant", {})):
        *mod, name = path
        if name not in _QUANT:
            raise KeyError(f"unexpected quant leaf {'/'.join(path)}")
        a = np.asarray(leaf)
        if name == "precision_mask":
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        sd[".".join(mod + [name])] = torch.tensor(a)
    for path, leaf in _leaves(tree.get("constants", {})):
        *mod, name = path
        if name not in _CONSTANTS:
            raise KeyError(f"unexpected constants leaf {'/'.join(path)}")
        sd[".".join(mod + [name])] = torch.tensor(
            np.asarray(leaf, np.float32))
    return sd


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`from_jax_variables`: JAX variables (nested dicts
    of numpy arrays) from a port ``state_dict``."""
    by_module: Dict[tuple, Dict[str, np.ndarray]] = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        by_module.setdefault(tuple(mod), {})[name] = (
            t.detach().cpu().numpy())
    out: Dict = {"params": {}, "quant": {}, "batch_stats": {},
                 "constants": {}}

    def put(coll, mod, name, value):
        node = out[coll]
        for p in mod:
            node = node.setdefault(p, {})
        node[name] = value

    for mod, leaves in by_module.items():
        is_bn = "running_mean" in leaves
        lead = 1 if "scan" in mod else 0  # the stacked layer axis
        for name, a in leaves.items():
            if is_bn:
                if name == "num_batches_tracked":
                    continue
                if name in _BN_STATS_INV:
                    put("batch_stats", mod, _BN_STATS_INV[name], a)
                else:
                    put("params", mod, _BN_PARAMS_INV[name], a)
            elif name in _QUANT:
                put("quant", mod, name, a)
            elif name in _CONSTANTS:
                put("constants", mod, name, a)
            elif name == "weight" and mod and (
                    mod[-1] == "embedding" or mod[-1].startswith("Embed")):
                put("params", mod, "embedding", a)
            elif name == "weight" and a.ndim == 4:
                put("params", mod, "kernel",
                    np.ascontiguousarray(a.transpose(2, 3, 1, 0)))
            elif name == "weight" and "alpha" not in leaves \
                    and a.ndim - lead == 1:  # LayerNorm
                put("params", mod, "scale", a)
            elif name == "weight" and a.ndim - lead == 2 \
                    and "alpha" not in leaves:
                put("params", mod, "kernel",
                    np.ascontiguousarray(np.swapaxes(a, -1, -2)))
            else:
                put("params", mod, name, a)
    return {k: v for k, v in out.items() if v}


_ATQ_KEYS = {"params": "atq_params", "quant": "quant",
             "batch_stats": "atq_batch_stats"}
_BASE_KEYS = {"params": "base_params", "batch_stats": "base_batch_stats"}


def from_jax_train_state(state: Dict):
    """``(atq_state_dict, base_state_dict)`` from the JAX classifier
    trainer's state (``atq_params``, ``quant``, ``atq_batch_stats``,
    ``base_params``, ``base_batch_stats``; numpy leaves). Optimizer state
    and the step count are not carried."""
    def pick(keys):
        return {coll: state[key] for coll, key in keys.items()
                if key in state}

    return (from_jax_variables(pick(_ATQ_KEYS)),
            from_jax_variables(pick(_BASE_KEYS)))


def to_jax_train_state(atq_state_dict: Dict[str, torch.Tensor],
                       base_state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`from_jax_train_state`: the JAX trainer's model
    variables (numpy leaves) from the two port state dicts."""
    out = {}
    for sd, keys in ((atq_state_dict, _ATQ_KEYS),
                     (base_state_dict, _BASE_KEYS)):
        variables = to_jax_variables(sd)
        for coll, key in keys.items():
            out[key] = variables.get(coll, {})
    return out
