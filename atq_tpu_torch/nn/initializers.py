"""Weight initialisers, each with an explicit generator.

- The quantized layers start from PyTorch's defaults,
  ``kaiming_uniform_(weight, a=sqrt(5))`` and a bias drawn from
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, as atq_tpu/nn/initializers.py
  reproduces them in JAX.
- The feature stack's convolutions and the teacher's dense layers are flax
  ``nn.Conv``/``nn.Dense`` in the JAX models, so they take flax's defaults:
  :func:`lecun_normal_` weights and zero biases.
- The encoder of the production-shape step (train/scale.py) uses flax's
  ``nn.Embed`` default (:func:`embed_default_`), ``nn.Dense`` default
  (:func:`lecun_normal_`, zero bias) and ``nn.LayerNorm`` (ones, zeros);
  :func:`normal_std_` is the JAX package's ``normal_std``, and
  :func:`xavier_uniform_gain_` its ``xavier_uniform_gain`` (the
  reference's text-tower re-init, models/text_encoder.py).

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


@torch.no_grad()
def xavier_uniform_gain_(tensor: torch.Tensor, gain: float = 0.8,
                         generator: Optional[torch.Generator] = None):
    """``xavier_uniform_`` with ``gain`` over the last two axes (fan-in
    the last, fan-out the one before): ``U(-b, b)``, ``b = gain ·
    sqrt(6 / (fan_in + fan_out))``; the reference's re-init of quantized
    networks (atq_tpu/nn/initializers.py:xavier_uniform_gain)."""
    shape = tensor.shape
    fan_in = shape[-1]
    fan_out = shape[-2] if len(shape) >= 2 else shape[-1]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_std_(tensor: torch.Tensor, std: float = 0.02,
                generator: Optional[torch.Generator] = None):
    """``std * N(0, 1)`` (atq_tpu/nn/initializers.py:normal_std)."""
    return tensor.normal_(0.0, std, generator=generator)


@torch.no_grad()
def embed_default_(tensor: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """flax's default ``nn.Embed`` init for a (num_embeddings, features)
    table: variance_scaling(1, "fan_in", "normal", out_axis=0), whose fan-in
    is the feature count, so an untruncated normal of std
    ``sqrt(1 / features)``."""
    return tensor.normal_(0.0, (1.0 / tensor.shape[1]) ** 0.5,
                          generator=generator)
