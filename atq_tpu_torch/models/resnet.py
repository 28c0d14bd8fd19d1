"""ResNet-18/50 backbone (port of atq_tpu/models/resnet.py).

The public input is NHWC (B, H, W, 3), as the JAX model takes it, and the
output is the globally pooled (B, feat_dim) feature (512 for resnet18, 2048
for resnet50). Inside, the convolutions run as PyTorch's OIHW convolutions
on an NCHW view of the input. Submodule names follow the flax names
(``conv1``, ``bn1``, ``layer{s}_{b}`` with ``conv1``/``bn1``/...,
``downsample_conv``/``downsample_bn``), so a JAX checkpoint maps onto the
state dict name for name; utils/jax_interop.py carries the flax HWIO
kernels across as OIHW.

BatchNorm follows flax's torch-like settings (momentum 0.1, eps 1e-5); the
serving port runs it in eval mode with the running statistics. The 3x3/2 max
pool pads with -inf, as flax's ``nn.max_pool`` does. When an int8 trunk is
attached (serve/int8_trunk.py ``attach_int8_collection``), ResNetFeatures
serves from it instead of the float path, as the JAX module does when it
finds ``('int8', 'trunk')``.

``ATQ_S2D_STEM`` and ``ATQ_FAST_POOL`` select XLA rewrites in the JAX package
(ops/s2d_stem.py, ops/fast_pool.py); they are not ported yet (ROADMAP.md
item 17) and raise when set. The torchvision state-dict importer waits for
slice G.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.models.image_classifier import _BatchNorm
from atq_tpu_torch.nn.initializers import lecun_normal_
from atq_tpu_torch.utils.platform import resolve_device

FEATURE_DIMS = {"resnet18": 512, "resnet50": 2048}


def _check_unported_flags() -> None:
    for flag in ("ATQ_S2D_STEM", "ATQ_FAST_POOL"):
        if os.environ.get(flag, "0") == "1":
            raise NotImplementedError(
                f"{flag}=1 is not ported yet (ROADMAP.md item 17)")


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          generator) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (k, k), use_bias=False)`` with its default
    ``lecun_normal`` init."""
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False, device="meta").to_empty(device="cpu")
    lecun_normal_(conv.weight.data, generator=generator)
    return conv


def _bn(features: int) -> _BatchNorm:
    return _BatchNorm(features, eps=1e-5, momentum=0.1)


class StemConv(nn.Conv2d):
    """The 7x7/stride-2/padding-3 stem conv (``conv1``), no bias."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__(cin, features, 7, stride=2, padding=3, bias=False,
                         device="meta")
        self.to_empty(device="cpu")
        lecun_normal_(self.weight.data, generator=generator)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1,
                 generator=None):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, strides, 1, generator)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, 1, generator)
        self.bn2 = _bn(features)
        if strides != 1 or cin != features:
            self.downsample_conv = _conv(cin, features, 1, strides, 0,
                                         generator)
            self.downsample_bn = _bn(features)

    def forward(self, x):  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1,
                 generator=None):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1, 1, 0, generator)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, strides, 1, generator)
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, out, 1, 1, 0, generator)
        self.bn3 = _bn(out)
        if strides != 1 or cin != out:
            self.downsample_conv = _conv(cin, out, 1, strides, 0, generator)
            self.downsample_bn = _bn(out)

    def forward(self, x):  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNetFeatures(nn.Module):
    """Headless ResNet: NHWC images -> pooled features (B, feat_dim).
    Built in eval mode."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block=BasicBlock, width: int = 64, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        self.conv1 = StemConv(in_channels, width, generator)
        self.bn1 = _bn(width)
        cin = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            features = width * (2 ** stage)
            for b in range(num_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        block(cin, features, strides, generator))
                cin = features * block.expansion
        # Serving tree from serve/int8_trunk.py (attach_int8_collection).
        self.int8_trunk = None
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        _check_unported_flags()
        if self.int8_trunk is not None:
            from atq_tpu_torch.serve.int8_trunk import int8_resnet_apply

            return int8_resnet_apply(self.int8_trunk, x, self.stage_sizes,
                                     bottleneck=self.block is Bottleneck)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for stage, num_blocks in enumerate(self.stage_sizes):
            for b in range(num_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        return x.mean(dim=(2, 3))  # global average pool

