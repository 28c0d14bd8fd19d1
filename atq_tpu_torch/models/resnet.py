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
serving port runs it in eval mode with the running statistics.

``dtype`` is the convolutions' compute dtype (AMP, as the JAX modules'
``dtype``): a convolution casts its input and kernel to it and gives its
output in it, as flax's ``nn.Conv(dtype=bfloat16)`` does; BatchNorm takes
its input as float32 and computes in float32 (the JAX ``_BN`` has
``dtype=float32``), so everything between two convolutions stays float32.

The 3x3/2 max pool pads with -inf, as flax's ``nn.max_pool`` does. When
an int8 trunk is attached (serve/int8_trunk.py ``attach_int8_collection``),
ResNetFeatures serves from it instead of the float path, as the JAX module
does when it finds ``('int8', 'trunk')``.

``ATQ_S2D_STEM=1`` runs the stem as the exact space-to-depth rewrite
(ops/s2d_stem.py: a 4x4/1 conv over 12 channels; the parameter stays
(K, C, 7, 7)) and ``ATQ_FAST_POOL=1`` the stem pool with the tie-splitting
backward (ops/fast_pool.py), as in the JAX package; both are read at each
forward and off by default. The int8 trunk keeps its plain pool: it is
forward only, where the two agree.

:func:`load_torch_state_dict` turns a torchvision ResNet state dict into the
JAX layout's ``(params, batch_stats)`` trees (numpy leaves), the trees
atq_tpu's importer gives; ``from_jax_variables({"params": params,
"batch_stats": stats})`` (utils/jax_interop.py) makes them this module's
state dict. :func:`load_imagenet_weights` reads a torchvision IMAGENET1K_V1
``.pth`` from disk after checking its sha256 against
:data:`IMAGENET_MANIFEST`'s prefix; nothing is downloaded.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.models.image_classifier import _BatchNorm
from atq_tpu_torch.nn.initializers import lecun_normal_
from atq_tpu_torch.ops.fast_pool import max_pool
from atq_tpu_torch.ops.s2d_stem import s2d_stem_enabled, stem_conv
from atq_tpu_torch.utils.platform import resolve_device

FEATURE_DIMS = {"resnet18": 512, "resnet50": 2048}


class Conv(nn.Conv2d):
    """flax ``nn.Conv(cout, (k, k), use_bias=False, dtype=dtype)`` with its
    default ``lecun_normal`` init: under a compute ``dtype`` the input and
    the kernel are cast to it and the output stays in it."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, generator=None, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False, device="meta")
        self.to_empty(device="cpu")
        lecun_normal_(self.weight.data, generator=generator)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return self._conv_forward(x.to(self.compute_dtype),
                                  self.weight.to(self.compute_dtype), None)


class StemConv(Conv):
    """The 7x7/stride-2/padding-3 stem conv (``conv1``), no bias; through
    the space-to-depth rewrite under ``ATQ_S2D_STEM=1``."""

    def __init__(self, cin: int, features: int, generator=None, dtype=None):
        super().__init__(cin, features, 7, 2, 3, generator, dtype)

    def forward(self, x):
        if not s2d_stem_enabled():
            return super().forward(x)
        weight = self.weight
        if self.compute_dtype is not None:
            x, weight = x.to(self.compute_dtype), weight.to(self.compute_dtype)
        return stem_conv(x, weight, use_s2d=True)


class _BatchNorm32(_BatchNorm):
    """The JAX ``_BN``: its input is taken as float32 (a compute-dtype
    convolution's output is cast up before it) and it computes in float32.
    A float32 input passes as it is."""

    def forward(self, x):
        return super().forward(x.float())


def _bn(features: int) -> _BatchNorm32:
    return _BatchNorm32(features, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1,
                 generator=None, dtype=None):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, strides, 1, generator, dtype)
        self.bn1 = _bn(features)
        self.conv2 = Conv(features, features, 3, 1, 1, generator, dtype)
        self.bn2 = _bn(features)
        if strides != 1 or cin != features:
            self.downsample_conv = Conv(cin, features, 1, strides, 0,
                                        generator, dtype)
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
                 generator=None, dtype=None):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv(cin, features, 1, 1, 0, generator, dtype)
        self.bn1 = _bn(features)
        self.conv2 = Conv(features, features, 3, strides, 1, generator,
                          dtype)
        self.bn2 = _bn(features)
        self.conv3 = Conv(features, out, 1, 1, 0, generator, dtype)
        self.bn3 = _bn(out)
        if strides != 1 or cin != out:
            self.downsample_conv = Conv(cin, out, 1, strides, 0, generator,
                                        dtype)
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
    Built in eval mode; ``dtype`` is the convolutions' compute dtype."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block=BasicBlock, width: int = 64, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype=None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        self.conv1 = StemConv(in_channels, width, generator, dtype)
        self.bn1 = _bn(width)
        cin = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            features = width * (2 ** stage)
            for b in range(num_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        block(cin, features, strides, generator, dtype))
                cin = features * block.expansion
        # Serving tree from serve/int8_trunk.py (attach_int8_collection).
        self.int8_trunk = None
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        if self.int8_trunk is not None:
            from atq_tpu_torch.serve.int8_trunk import int8_resnet_apply

            return int8_resnet_apply(self.int8_trunk, x, self.stage_sizes,
                                     bottleneck=self.block is Bottleneck)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x)  # 3x3/2, padded with -inf
        for stage, num_blocks in enumerate(self.stage_sizes):
            for b in range(num_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        return x.mean(dim=(2, 3))  # global average pool



def resnet18_features(device=None,
                      generator: Optional[torch.Generator] = None,
                      dtype=None) -> ResNetFeatures:
    """Headless ResNet-18 (BasicBlock, stages 2-2-2-2; 512 features)."""
    return ResNetFeatures((2, 2, 2, 2), BasicBlock, device=device,
                          generator=generator, dtype=dtype)


def resnet50_features(device=None,
                      generator: Optional[torch.Generator] = None,
                      dtype=None) -> ResNetFeatures:
    """Headless ResNet-50 (Bottleneck, stages 3-4-6-3; 2048 features)."""
    return ResNetFeatures((3, 4, 6, 3), Bottleneck, device=device,
                          generator=generator, dtype=dtype)


def _torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    # torch conv weight (O, I, kh, kw) -> flax (kh, kw, I, O)
    return np.transpose(w, (2, 3, 1, 0))


def load_torch_state_dict(state_dict: dict, arch: str = "resnet18"):
    """A torchvision ResNet state dict (numpy arrays or torch tensors) ->
    the JAX layout's ``(params, batch_stats)`` trees for
    :class:`ResNetFeatures`, numpy leaves (atq_tpu/models/resnet.py's
    ``load_torch_state_dict``, leaf for leaf)."""
    def npy(v):
        return v.numpy() if hasattr(v, "numpy") else np.asarray(v)

    sd = {k: npy(v) for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value)

    def conv(flax_path, torch_name):
        put(params, flax_path + ("kernel",),
            _torch_conv_to_flax(sd[torch_name + ".weight"]))

    def bn(flax_path, torch_name):
        put(params, flax_path + ("scale",), sd[torch_name + ".weight"])
        put(params, flax_path + ("bias",), sd[torch_name + ".bias"])
        put(stats, flax_path + ("mean",), sd[torch_name + ".running_mean"])
        put(stats, flax_path + ("var",), sd[torch_name + ".running_var"])

    conv(("conv1",), "conv1")
    bn(("bn1",), "bn1")
    stage_sizes = (2, 2, 2, 2) if arch == "resnet18" else (3, 4, 6, 3)
    n_convs = 2 if arch == "resnet18" else 3
    for stage, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            prefix = f"layer{stage + 1}.{b}"
            fpfx = (f"layer{stage + 1}_{b}",)
            for c in range(1, n_convs + 1):
                conv(fpfx + (f"conv{c}",), f"{prefix}.conv{c}")
                bn(fpfx + (f"bn{c}",), f"{prefix}.bn{c}")
            if f"{prefix}.downsample.0.weight" in sd:
                conv(fpfx + ("downsample_conv",), f"{prefix}.downsample.0")
                bn(fpfx + ("downsample_bn",), f"{prefix}.downsample.1")
    return params, stats


# torchvision's IMAGENET1K_V1 release files. torchvision's own download
# checks the sha256 prefix in the file name; the same prefix checks a file
# copied onto a machine without network.
IMAGENET_MANIFEST = {
    "resnet18": {
        "url": "https://download.pytorch.org/models/resnet18-f37072fd.pth",
        "sha256_prefix": "f37072fd",
    },
    "resnet50": {
        "url": "https://download.pytorch.org/models/resnet50-0676ba61.pth",
        "sha256_prefix": "0676ba61",
    },
}


def load_imagenet_weights(path: str, arch: str = "resnet18",
                          verify_hash: bool = True):
    """A torchvision IMAGENET1K_V1 ``.pth`` on disk -> the JAX layout's
    ``(params, batch_stats)`` trees (:func:`load_torch_state_dict`).
    ``verify_hash`` (the default) checks the file's sha256 against the
    manifest prefix and raises ValueError, as the JAX loader does."""
    if verify_hash:
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        want = IMAGENET_MANIFEST[arch]["sha256_prefix"]
        if not digest.startswith(want):
            raise ValueError(
                f"{path}: sha256 {digest[:16]}... does not start with the "
                f"manifest prefix {want!r} for {arch} IMAGENET1K_V1 "
                f"({IMAGENET_MANIFEST[arch]['url']})"
            )
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return load_torch_state_dict(state_dict, arch=arch)
