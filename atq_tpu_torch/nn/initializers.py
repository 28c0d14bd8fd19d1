"""PyTorch's default Linear/Conv initialisation, with an explicit generator.

The quantized layers start from ``kaiming_uniform_(weight, a=sqrt(5))`` and
a bias drawn from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, as
atq_tpu/nn/initializers.py reproduces in JAX. The two frameworks draw
different numbers from one seed, so cross-checks carry weights across
(utils/jax_interop.py) rather than re-drawing them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _fan_in(shape) -> int:
    fan_in = shape[1]
    for d in shape[2:]:
        fan_in *= d
    return fan_in


@torch.no_grad()
def kaiming_uniform_torch_(tensor: torch.Tensor, a: float = math.sqrt(5),
                           generator: Optional[torch.Generator] = None):
    """``kaiming_uniform_`` for (out, in, ...)-shaped weights:
    ``bound = sqrt(2 / (1 + a^2)) * sqrt(3 / fan_in)``."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / _fan_in(tensor.shape))
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def bias_uniform_torch_(tensor: torch.Tensor, fan_in: int,
                        generator: Optional[torch.Generator] = None):
    """PyTorch's default bias: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(fan_in)
    return tensor.uniform_(-bound, bound, generator=generator)
