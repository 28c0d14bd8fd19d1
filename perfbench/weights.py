"""The cell's inputs from its seed: the model's tensors and the batch.

Both sides get these: the program has its parameters and buffers
overwritten with them before its first step, and the reference
(perfbench/reference.py) starts from them. Everything is drawn on the
device, by one ``torch.Generator`` there, in one call, and spread over the
leaves:

- projection weights and biases, the head's weight and the embedding:
  uniform with the variance of the program's own init (``U(-b, b)``,
  ``b = 1/sqrt(fan_in)``: PyTorch's default linear init; the embedding
  and head at std ``1/sqrt(E)``);
- each projection's alpha: its layer's optimal scale, ``sum(w * w_t) /
  nnz(w_t)`` of its ternary pattern at the config's sparsity (the
  quantizer's own rule), so that the effective weight is on the latent
  weight's scale. At the program's init value 1 the effective weight's
  entries are ±1, some 28 times the latent weights at width 768, every
  attention row saturates to its largest score, and any rounding moves
  the gradients by a tenth (PERF.md);
- gate 0.8, LayerNorms 1 and 0, the head's bias 0: the program's
  constants;
- each projection's precision mask: its layer's largest
  ``precision_ratio`` of |w| (ties at the cut kept), the RPB rule;
- the sparsity buffer: the config's ``sparsity``.

The batch is the program's own draw (atq_tpu_torch/train/scale.py
``build_step``): ``numpy.random.RandomState(seed)``, tokens ``randint(0,
vocab, (batch, seq))`` then labels ``randint(0, classes, (batch,))``.
The program draws the same from the seed it is given; the check compares
losses, so a batch that differed would show.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import (
    KINDS,
    STACK,
    kind_shapes,
    tensor_specs,
    ternary,
    thresholds,
)

CONSTANTS = {"gate": 0.8}


def program_seed(seed: int) -> int:
    """The seed as numpy's RandomState takes it (0 <= seed < 2**32)."""
    return int(seed) % 2 ** 32


def _bound(name: str, cfg: dict) -> float:
    """Half-width of a random leaf's uniform draw."""
    if name in ("Embed_0.weight", "Dense_0.weight"):
        return math.sqrt(3.0 / cfg["hidden_size"])
    kind = name[len(STACK):].rsplit(".", 1)[0]
    return 1.0 / math.sqrt(kind_shapes(cfg)[kind][1])


def _random(name: str) -> bool:
    if name in ("Embed_0.weight", "Dense_0.weight"):
        return True
    kind, _, leaf = name[len(STACK):].rpartition(".")
    return name.startswith(STACK) and kind in KINDS \
        and leaf in ("weight", "bias")


def _constant(name: str, cfg: dict) -> float:
    leaf = name.rsplit(".", 1)[1]
    if leaf in CONSTANTS:
        return CONSTANTS[leaf]
    if leaf == "sparsity_target":
        return cfg["sparsity"]
    return 1.0 if leaf == "weight" else 0.0  # LayerNorms; the head's bias


@torch.no_grad()
def precision_mask(w: torch.Tensor, ratio: float) -> torch.Tensor:
    """Each layer's largest ``ratio`` of |w| (a stacked (L, out, in)
    weight), ties at the cut kept."""
    flat = w.abs().reshape(w.shape[0], -1)
    k = int(ratio * flat.shape[1])
    if k == 0:
        return torch.zeros_like(w, dtype=torch.bool)
    cut = torch.topk(flat, k, dim=1, sorted=False).values.amin(dim=1)
    return (flat >= cut[:, None]).reshape(w.shape)


@torch.no_grad()
def make_tensors(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of :func:`perfbench.reference.tensor_specs`, drawn from
    ``seed`` on ``device``."""
    specs = tensor_specs(cfg)
    random = [(n, s) for n, s, _, _ in specs if _random(n)]
    total = sum(math.prod(s) for _, s in random)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        out[name] = (draw[offset:offset + n].view(shape) * 2.0 - 1.0) \
            * _bound(name, cfg)
        offset += n
    del draw
    for name, shape, dtype, _ in specs:
        if name in out or name.endswith(".alpha"):
            continue
        if dtype == torch.bool:
            kind = name[len(STACK):].rsplit(".", 1)[0]
            out[name] = precision_mask(out[STACK + kind + ".weight"],
                                       cfg["precision_ratio"][kind])
        else:
            out[name] = torch.full(shape, _constant(name, cfg), dtype=dtype,
                                   device=device)
    for kind in KINDS:
        out[STACK + kind + ".alpha"] = optimal_alpha(
            out[STACK + kind + ".weight"],
            out[STACK + kind + ".sparsity_target"])
    return out


@torch.no_grad()
def optimal_alpha(w: torch.Tensor, sparsity: torch.Tensor) -> torch.Tensor:
    """Per layer (L, 1): ``sum(w * w_t) / nnz(w_t)`` of a stacked
    weight's ternary pattern."""
    w_t = ternary(w, thresholds(w, sparsity))
    dims = tuple(range(1, w.ndim))
    nnz = (w_t != 0).sum(dim=dims).clamp(min=1).to(w.dtype)
    return ((w * w_t).sum(dim=dims) / nnz)[:, None]


def draw_batch(cfg: dict, traffic: dict, seed: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tokens (batch, seq), labels (batch,))`` as int64 on ``device``."""
    rng = np.random.RandomState(program_seed(seed))
    tokens = rng.randint(0, cfg["vocab_size"],
                         (traffic["batch"], traffic["seq"]))
    labels = rng.randint(0, cfg["num_classes"], (traffic["batch"],))
    return (torch.from_numpy(tokens).long().to(device),
            torch.from_numpy(labels).long().to(device))
