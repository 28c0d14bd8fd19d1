"""Ahead-of-time serving programs via ``torch.export``.

Port of atq_tpu/serve/aot.py. The deployable artifact is the exported
program, not the Python model: ``torch.export`` traces a serving function
once (its weights lifted into the program), ``torch.export.save`` writes
it as a ``.pt2`` archive, and a later process reloads and runs it with no
model code and no retrace. Where the JAX package serializes StableHLO, the
port's artifact is ``torch.export``'s graph of ATen ops, in which every
CUDA kernel of the eval forward stands as one registered op
(``torch.ops.atq_tpu_torch.order_stat``, ``ternary_matmul``,
``ternary_matmul32``, ``ternary_matmul_rpb``, ``fused_forward``;
ops/__init__.py). So a loaded program launches the same kernels as the
live model, and loading needs ``atq_tpu_torch.ops`` imported (this module
imports it) and no model module.

Two export shapes, as in the JAX package:

- **Batch-polymorphic** (the default): the leading axis of every argument
  is ``Dim("b", min=1, max=MAX_BATCH)``, so one program serves every batch
  the micro-batching engine forms, 1 included.
- **Bucketed**: one fixed-shape program per batch bucket, for a function
  that rejects a symbolic batch; ``export_serving`` falls back to it. A
  batch is padded with zeros up to the smallest bucket that holds it and
  the outputs are sliced back. Where a function mixes rows of a batch
  (the int8 trunk's one activation scale a batch), the padding changes
  the answers; the polymorphic form has no padding.

An artifact is a directory: ``manifest.json`` (format
``atq_tpu_torch.aot.v1``, ``poly``, ``exports``, ``arg_specs``,
``platforms``, ``torch_version``) and one ``.pt2`` a program. It loads
only on the device type it was exported for. A JAX artifact
(``atq_tpu.aot.v1``) is refused.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

import atq_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)

FORMAT = "atq_tpu_torch.aot.v1"
JAX_FORMAT = "atq_tpu.aot.v1"
# The symbolic batch's upper end: on the card, torch.export refines any
# larger one to this (a guard of the CUDA path), and a declared range it
# must narrow is refused.
MAX_BATCH = (1 << 16) - 1
_MANIFEST = "manifest.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _arg_specs(example_args) -> List[Dict]:
    """JSON-able shape/dtype signature of the example args."""
    return [{"shape": list(a.shape), "dtype": _dtype_name(a.dtype)}
            for a in example_args]


class _Program(torch.nn.Module):
    """``fn`` as a module for ``torch.export``, its arguments as
    ``*args``. A module, or a bound method of one, keeps that module as a
    submodule, so its weights export as the program's parameters and
    buffers; any other callable's tensors export as constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        owner = getattr(fn, "__self__", None)
        if isinstance(owner, torch.nn.Module):
            self.owner, self._method, self._fn = owner, fn.__name__, None
        else:
            self._fn = fn

    def forward(self, *args):
        if self._fn is None:
            return getattr(self.owner, self._method)(*args)
        return self._fn(*args)


def _export(module, args, dynamic_shapes=None):
    with torch.no_grad():  # eval programs: the kernels' ops, no autograd
        return torch.export.export(module, tuple(args),
                                   dynamic_shapes=dynamic_shapes)


def export_serving(fn: Callable, example_args: Sequence[torch.Tensor],
                   batch_polymorphic: bool = True,
                   buckets: Sequence[int] = ()) -> "AOTServing":
    """Trace ``fn`` once and wrap the exported program(s) for serving.

    Args:
        fn: per-batch function (a leading batch axis on every argument),
            a module or a callable; a bound method of a module exports
            with that module's weights.
        example_args: one example batch of tensors, on the device the
            program is for (its dtypes and trailing shapes).
        batch_polymorphic: export once with a symbolic batch. On failure
            (a program that rejects a symbolic batch) fall back to the
            bucketed form, with a warning that says why.
        buckets: batch sizes of the bucketed form; by default the example
            batch size only.
    """
    example_args = tuple(example_args)
    module = _Program(fn)
    device = example_args[0].device
    programs = {}
    if batch_polymorphic:
        if any(a.ndim == 0 for a in example_args):
            raise ValueError("batch-polymorphic export needs a leading "
                             "batch axis on every argument; got a scalar "
                             "(stack requests first)")
        b = torch.export.Dim("b", min=1, max=MAX_BATCH)
        try:
            programs["poly"] = _export(
                module, example_args, (tuple({0: b} for _ in example_args),))
        except Exception as e:  # noqa: BLE001 -- any refusal: go bucketed
            warnings.warn(f"batch-polymorphic export failed, exporting "
                          f"buckets instead: {type(e).__name__}: {e}")
    poly = "poly" in programs
    if not poly:
        sizes = sorted(set(buckets)) or [int(example_args[0].shape[0])]
        for size in sizes:
            args = tuple(torch.zeros((size, *a.shape[1:]), dtype=a.dtype,
                                     device=a.device) for a in example_args)
            programs[f"b{size}"] = _export(module, args)
    return AOTServing(programs, _arg_specs(example_args), poly=poly,
                      platform=device.type)


class AOTServing:
    """A (re)loaded export, callable like the function it was made from.

    Takes tensors on its device, or numpy arrays (cast to the exported
    dtypes and moved to the device; the outputs then come back as numpy
    arrays, so it can stand as a ``BatchServer``'s ``apply_fn``).
    Polymorphic artifacts take any batch from 1 to ``MAX_BATCH``; bucketed
    ones pad up to the smallest bucket that holds the batch and slice the
    outputs back.
    """

    def __init__(self, programs: Dict[str, torch.export.ExportedProgram],
                 arg_specs: List[Dict], poly: bool, platform: str):
        self._programs = programs
        self._modules = {k: ep.module() for k, ep in programs.items()}
        self._arg_specs = arg_specs
        self._poly = poly
        self._device = torch.device(platform)
        if not poly:
            self._sizes = sorted(int(k[1:]) for k in programs)

    @property
    def batch_polymorphic(self) -> bool:
        return self._poly

    @property
    def platforms(self) -> Tuple[str, ...]:
        return (self._device.type,)

    @property
    def programs(self) -> Dict[str, torch.export.ExportedProgram]:
        """The exported programs by key (``poly`` or ``b<size>``)."""
        return dict(self._programs)

    def _pick(self, n: int) -> int:
        for s in self._sizes:
            if n <= s:
                return s
        raise ValueError(f"batch {n} exceeds largest exported bucket "
                         f"{self._sizes[-1]}")

    def _tensor(self, a, spec) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a
        dtype = getattr(torch, spec["dtype"])
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self._device, dtype)

    @torch.inference_mode()
    def __call__(self, *args):
        host = any(not isinstance(a, torch.Tensor) for a in args)
        args = tuple(self._tensor(a, s)
                     for a, s in zip(args, self._arg_specs))
        n = int(args[0].shape[0])
        if self._poly:
            out = self._modules["poly"](*args)
        else:
            size = self._pick(n)
            if size != n:
                args = tuple(torch.cat([a, a.new_zeros((size - n,
                                                        *a.shape[1:]))])
                             for a in args)
            out = self._modules[f"b{size}"](*args)
            if size != n:
                out = (tuple(o[:n] for o in out) if isinstance(out, tuple)
                       else out[:n])
        if host:
            return (tuple(o.cpu().numpy() for o in out)
                    if isinstance(out, tuple) else out.cpu().numpy())
        return out

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the artifact directory (manifest + one ``.pt2`` a
        program)."""
        os.makedirs(path, exist_ok=True)
        names = {}
        for key, ep in self._programs.items():
            names[key] = f"{key}.pt2"
            torch.export.save(ep, os.path.join(path, names[key]))
        manifest = {"format": FORMAT, "poly": self._poly, "exports": names,
                    "arg_specs": self._arg_specs,
                    "platforms": list(self.platforms),
                    "torch_version": torch.__version__}
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "AOTServing":
        """Reload a saved artifact: no model code, no retrace. Raises on a
        directory of another format (a JAX artifact among them) and on a
        ``cuda`` artifact where no GPU is present."""
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt == JAX_FORMAT:
            raise ValueError(
                f"{path} holds a JAX artifact ({JAX_FORMAT}: serialized "
                f"StableHLO); the port loads only its own ({FORMAT}). "
                f"Export it again with atq_tpu_torch.serve --aot.")
        if fmt != FORMAT:
            raise ValueError(f"{path}: not an {FORMAT} artifact "
                             f"(format {fmt!r})")
        platform = manifest["platforms"][0]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for cuda and this "
                               f"host has no GPU")
        programs = {key: torch.export.load(os.path.join(path, fname))
                    for key, fname in manifest["exports"].items()}
        return cls(programs, manifest["arg_specs"], poly=manifest["poly"],
                   platform=platform)


def load_serving(path: str) -> AOTServing:
    """Module-level alias for :meth:`AOTServing.load`."""
    return AOTServing.load(path)
