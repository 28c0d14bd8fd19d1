"""Weight initialisers, each with an explicit generator.

- The quantized layers start from PyTorch's defaults,
  ``kaiming_uniform_(weight, a=sqrt(5))`` and a bias drawn from
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, as atq_tpu/nn/initializers.py
  reproduces them in JAX.
- The feature stack's convolutions and the teacher's dense layers are flax
  ``nn.Conv``/``nn.Dense`` in the JAX models, so they take flax's defaults:
  :func:`lecun_normal_` weights and zero biases.

The two frameworks draw different numbers from one seed, so cross-checks
carry weights across (utils/jax_interop.py) rather than re-drawing them;
the distributions are what must agree.
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


# flax's variance_scaling divides the truncated normal's stddev by the std
# of a unit normal truncated to (-2, 2), so that the drawn values have the
# requested variance.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """flax's default kernel init (``lecun_normal``: variance_scaling(1,
    "fan_in", "truncated_normal")) for (out, in, ...)-shaped weights: a
    normal truncated at ±2 of its stddev ``sqrt(1 / fan_in) / 0.8796…``,
    so the values' std is ``sqrt(1 / fan_in)``."""
    std = (1.0 / _fan_in(tensor.shape)) ** 0.5 / _TRUNC_STD
    return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std,
                                       2.0 * std, generator=generator)


@torch.no_grad()
def bias_uniform_torch_(tensor: torch.Tensor, fan_in: int,
                        generator: Optional[torch.Generator] = None):
    """PyTorch's default bias: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(fan_in)
    return tensor.uniform_(-bound, bound, generator=generator)
