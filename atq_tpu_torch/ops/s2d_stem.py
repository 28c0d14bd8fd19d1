"""Space-to-depth stem (port of atq_tpu/ops/s2d_stem.py): the ResNet's
7x7/stride-2 stem conv as an exact 4x4/stride-1 conv over a 2x2
space-to-depth input, behind ``ATQ_S2D_STEM=1``.

In JAX this is an XLA rewrite, not a Pallas kernel, so here it is plain
torch ops, in the port's layouts: NCHW activations and OIHW kernels.

Derivation (1-D; 2-D is the tensor product). The stem computes
``o[i] = sum_{a=0..6} x[2i + a - 3] · w[a]`` (padding 3). Pad the kernel
on the left to 8 taps, ``w8[0] = 0``, split ``a' = 2A + dr`` (A in 0..3,
dr in {0, 1}) and read ``y[p, dr] = x[2p + dr]``: then
``o[i] = sum_A sum_dr y[i - 2 + A, dr] · w8[2A + dr]``, a stride-1 4-tap
conv over ``y`` with padding (2, 1). Every zero-padding position of ``x``
maps to one of ``y``, so the two are equal up to float reassociation.

The latent parameter stays the (K, C, 7, 7) stem kernel, so checkpoints
and the torchvision importer do not see which path runs. Odd spatial sizes
take the direct conv.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F


def s2d_stem_enabled() -> bool:
    """``ATQ_S2D_STEM=1``, read at each call (JAX reads it at trace
    time)."""
    return os.environ.get("ATQ_S2D_STEM", "0") == "1"


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2), each 2x2 spatial block folded
    into channels in (dr, dc, c) order (JAX's NHWC channel order)."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H, W; got {(h, w)}")
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)    # N, C, H/2, dr, W/2, dc
    x = x.permute(0, 3, 5, 1, 2, 4)              # N, dr, dc, C, H/2, W/2
    return x.reshape(n, 4 * c, h // 2, w // 2)


def pack_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(K, C, 7, 7) stem kernel -> (K, 4C, 4, 4) space-to-depth kernel:
    padded to 8x8 with a zero leading row and column, each spatial axis
    split into (block, offset), the offsets moved into the input channels
    in :func:`space_to_depth`'s order."""
    k, c, kh, kw = weight.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {(kh, kw)}")
    w8 = F.pad(weight, (1, 0, 1, 0))
    w8 = w8.reshape(k, c, 4, 2, 4, 2)            # K, C, A, dr, B, dc
    w8 = w8.permute(0, 3, 5, 1, 2, 4)            # K, dr, dc, C, A, B
    return w8.reshape(k, 4 * c, 4, 4)


def stem_conv(x: torch.Tensor, weight: torch.Tensor,
              use_s2d: Optional[bool] = None) -> torch.Tensor:
    """The stem conv (7x7, stride 2, padding 3, no bias) of NCHW ``x``,
    directly or through the space-to-depth rewrite. ``use_s2d=None`` reads
    ``ATQ_S2D_STEM``; odd H or W take the direct conv."""
    if use_s2d is None:
        use_s2d = s2d_stem_enabled()
    if use_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        y = F.pad(space_to_depth(x), (2, 1, 2, 1))
        return F.conv2d(y, pack_stem_kernel(weight))
    return F.conv2d(x, weight, stride=2, padding=3)
