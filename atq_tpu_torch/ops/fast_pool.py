"""Max pooling with a dense backward that splits ties (port of
atq_tpu/ops/fast_pool.py), behind ``ATQ_FAST_POOL=1``.

In JAX this replaces XLA's select-and-scatter backward of the ResNet stem's
3x3/2 max pool with masked strided adds; it is an XLA rewrite, not a
Pallas kernel, so here it is a ``torch.autograd.Function`` of plain torch
ops, on NCHW tensors.

- The forward is max pooling with -inf padding, bit for bit.
- The backward splits each window's gradient equally among its tied
  maxima (``g / tie_count``), so the window's gradient sum is kept, where
  PyTorch's and XLA's route it all to one tied element. Post-ReLU maps tie
  at 0 often, so this is off the parity path; with unique maxima the two
  backwards agree.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

Pad2 = Tuple[Tuple[int, int], Tuple[int, int]]


def fast_pool_enabled() -> bool:
    """``ATQ_FAST_POOL=1``, read at each call (JAX reads it at trace
    time)."""
    return os.environ.get("ATQ_FAST_POOL", "0") == "1"


def _padded(x: torch.Tensor, padding: Pad2) -> torch.Tensor:
    (top, bottom), (left, right) = padding
    return F.pad(x, (left, right, top, bottom), value=float("-inf"))


def _offset_views(xp: torch.Tensor, window, strides, out_hw):
    """For each window offset (di, dj), the padded input's elements that
    land there, (N, C, Ho, Wo), with the slices that address them."""
    ho, wo = out_hw
    for di in range(window[0]):
        for dj in range(window[1]):
            rows = slice(di, di + strides[0] * (ho - 1) + 1, strides[0])
            cols = slice(dj, dj + strides[1] * (wo - 1) + 1, strides[1])
            yield rows, cols, xp[:, :, rows, cols]


def _reduce_max(x, window, strides, padding):
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:  # max_pool2d pads with -inf itself
        return F.max_pool2d(x, window, stride=strides, padding=(top, left))
    return F.max_pool2d(_padded(x, padding), window, stride=strides)


class _FastMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        y = _reduce_max(x, window, strides, padding)
        ctx.save_for_backward(x, y)
        ctx.args = (window, strides, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, strides, padding = ctx.args
        xp = _padded(x, padding)
        out_hw = y.shape[2:]
        ties = sum((view == y).to(g.dtype) for _, _, view in
                   _offset_views(xp, window, strides, out_hw))
        gsplit = g / ties
        gp = torch.zeros_like(xp, dtype=g.dtype)
        for rows, cols, view in _offset_views(xp, window, strides, out_hw):
            gp[:, :, rows, cols] += torch.where(view == y, gsplit,
                                                torch.zeros_like(gsplit))
        (top, _), (left, _) = padding
        gx = gp[:, :, top:top + x.shape[2], left:left + x.shape[3]]
        return gx.to(x.dtype), None, None, None


def fast_max_pool(x: torch.Tensor, window: Tuple[int, int] = (3, 3),
                  strides: Tuple[int, int] = (2, 2),
                  padding: Pad2 = ((1, 1), (1, 1))) -> torch.Tensor:
    """NCHW max pool: forward as max pooling with -inf padding, backward
    splitting tied maxima's gradient equally."""
    return _FastMaxPool.apply(x, tuple(window), tuple(strides),
                              tuple(map(tuple, padding)))


def max_pool(x: torch.Tensor, window: Tuple[int, int] = (3, 3),
             strides: Tuple[int, int] = (2, 2),
             padding: Pad2 = ((1, 1), (1, 1))) -> torch.Tensor:
    """PyTorch's max pool (the parity default), or :func:`fast_max_pool`
    under ``ATQ_FAST_POOL=1``."""
    if fast_pool_enabled():
        return fast_max_pool(x, window, strides, padding)
    return _reduce_max(x, window, strides, padding)
