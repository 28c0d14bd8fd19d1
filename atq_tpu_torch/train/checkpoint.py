"""Resumable training state (port of atq_tpu/train/checkpoint.py).

The JAX package writes its training state with Orbax; the port writes one
``torch.save`` file per step, ``directory/step_N``:

- the state is a nested dict of tensors, Python numbers and strings (the
  trainers' ``*_train_state`` functions build it from their live
  objects); :func:`to_host` snapshots it on the host;
- the file is written under a temporary name in the same directory,
  flushed to disk and ``os.replace``d onto ``step_N``: a process killed
  mid-write (SIGKILL included) leaves the previous steps readable and at
  most a temporary file, which :func:`latest_step` ignores and the next
  save removes;
- after each save only the ``keep`` newest steps stay;
- saves are synchronous: a restore never waits for a writer;
- :func:`restore_train_state` loads with ``weights_only=True`` (tensors
  and plain containers only, no arbitrary pickles) onto the host; the
  trainers copy it into their live objects;
- a ``step_N`` that is a directory is a JAX Orbax state (the JAX trainers
  write theirs to the same paths): both functions raise ``ValueError``
  before they read or write anything. Neither format resumes on the other
  package; weights cross over through ``checkpoint_epoch_N.npz`` and
  utils/jax_interop.py.

:func:`state_digest` is a SHA-256 over every leaf's key, dtype, shape and
bytes: the trainers print it when they save and when they resume, so two
processes can show that a restored state is the saved one bit for bit.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_STEP = re.compile(r"step_(\d+)")
_TMP_PREFIX = ".tmp_step_"


def to_host(tree):
    """A snapshot of a state: every tensor copied to the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.fullmatch,
                                               os.listdir(directory)) if m)


def _refuse_orbax(directory: str, steps) -> None:
    """Raise ValueError if any ``directory/step_N`` of ``steps`` is a
    directory: a JAX Orbax state, which the port neither reads nor
    prunes."""
    for step in steps:
        path = os.path.join(directory, f"step_{step}")
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory, a JAX Orbax training state; the "
                f"port's training state is one torch.save file a step "
                f"(step_N). Neither resumes on the other package: carry "
                f"the weights over through checkpoint_epoch_N.npz and "
                f"atq_tpu_torch/utils/jax_interop.py, and give the port "
                f"its own output directory.")


def save_train_state(directory: str, step: int, state: Dict,
                     keep: int = 3) -> str:
    """Write ``state`` as ``directory/step_{step}`` (atomically, replacing
    a step of the same number) and keep the ``keep`` newest steps. Raises
    ValueError, before writing, when the directory holds a JAX Orbax
    step."""
    _refuse_orbax(directory, _steps(directory) + [step])
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):  # torn writes of a killed process
        if name.startswith(_TMP_PREFIX):
            os.remove(os.path.join(directory, name))
    path = os.path.join(directory, f"step_{step}")
    tmp = os.path.join(directory, f"{_TMP_PREFIX}{step}_{os.getpid()}")
    with open(tmp, "wb") as f:
        torch.save(to_host(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)  # the rename itself reaches the disk
    finally:
        os.close(fd)
    for old in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"step_{old}"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_train_state(directory: str, step: Optional[int] = None
                        ) -> Tuple[Dict, int]:
    """``(state, step)`` of ``step`` (the newest by default), on the host.
    Raises FileNotFoundError when there is none, and ValueError when it
    is a JAX Orbax step (a directory)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    _refuse_orbax(directory, [step])
    path = os.path.join(directory, f"step_{step}")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=True), step


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def state_digest(state: Any) -> str:
    """SHA-256 of a state's leaves (keys, dtypes, shapes and bytes)."""
    h = hashlib.sha256()
    for path, leaf in _leaves(state):
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def numpy_rng_state() -> Dict:
    """numpy's global RNG state as tensors and numbers."""
    kind, keys, pos, has_gauss, gauss = np.random.get_state()
    return {"kind": kind, "keys": torch.from_numpy(keys.astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(gauss)}


def set_numpy_rng_state(state: Dict) -> None:
    np.random.set_state((state["kind"],
                         state["keys"].numpy().astype(np.uint32),
                         state["pos"], state["has_gauss"],
                         state["cached_gaussian"]))


@torch.no_grad()
def copy_into(targets, values) -> None:
    """Copy saved tensors into live ones (on their devices), bit for bit;
    the lists must align."""
    targets, values = list(targets), list(values)
    if len(targets) != len(values):
        raise ValueError(f"state has {len(values)} tensors, "
                         f"expected {len(targets)}")
    for t, v in zip(targets, values):
        if t.shape != v.shape or t.dtype != v.dtype:
            raise ValueError(f"saved {v.dtype}{tuple(v.shape)} does not "
                             f"fit {t.dtype}{tuple(t.shape)}")
        t.copy_(v)
