"""Fashion-MNIST / MNIST image classifier with an ATQ head, and its
full-precision teacher.

Port of atq_tpu/models/image_classifier.py (``_ConvFeatures``,
``ATQImageClassifier``, ``BaselineCNNClassifier``): a full-precision CNN
feature stack
Conv(1->32, 3x3, pad 1) + BN + ReLU + MaxPool(2) twice, flattened to
64·7·7 = 3136 features for 28x28 inputs, identity selective routing, then
a two-layer quantized head (RPB with precision 0.05 / 0.1, or
TernaryLinear).

The public input is NHWC (B, H, W, C), as the JAX model takes it. The
convolutions run NCHW inside; the features are permuted back to NHWC before
the flatten, so the feature order is (H, W, C) as on the JAX side and the
head weights carry over with no column permutation. Submodule names follow
the flax names (``features``, ``conv1``, ``bn1``, ..., ``classifier_0``,
``classifier_3``, ``fc1``, ``fc2``), so a JAX checkpoint maps onto the
state dict name for name (utils/jax_interop.py).

Train mode (``model.train()``) follows flax: BatchNorm normalizes with the
batch statistics and moves its running statistics by momentum 0.1 towards
the batch mean and the *biased* batch variance (``nn.BatchNorm2d`` would
use the unbiased one), eps 1e-5; dropout keeps each unit with probability
``1 − dropout_rate`` and scales it by ``1 / (1 − dropout_rate)``, drawn from
the generator passed to ``forward``. The convolutions and the teacher's
dense layers start from flax's default init (``lecun_normal`` weights,
zero biases); the quantized head from PyTorch's defaults, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.nn.initializers import lecun_normal_
from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    TernaryLinear,
    apply_selective_routing,
    dropout,
)
from atq_tpu_torch.parallel.collectives import (
    active_data_shard,
    global_sum,
)
from atq_tpu_torch.utils.platform import resolve_device


def _flax_init(module: nn.Module, generator) -> nn.Module:
    # Built on the meta device so that construction draws nothing from the
    # global RNG; every value comes from `generator`.
    module = module.to_empty(device="cpu")
    lecun_normal_(module.weight.data, generator=generator)
    nn.init.zeros_(module.bias.data)
    return module


def _conv(cin: int, cout: int, generator) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (3, 3), padding=1)`` with its default init."""
    return _flax_init(nn.Conv2d(cin, cout, 3, padding=1, device="meta"),
                      generator)


def _dense(fan_in: int, features: int, generator) -> nn.Linear:
    """flax ``nn.Dense(features)`` with its default init."""
    return _flax_init(nn.Linear(fan_in, features, device="meta"), generator)


class _BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode statistics: the running
    variance moves towards the biased batch variance.

    Inside a data-parallel step (parallel/collectives.py ``data_shard``)
    the statistics are the global batch's, as under JAX's GSPMD: the
    ranks' sums of x and x² are all-reduced (differentiably) and the
    variance is flax's ``max(0, E[x²] − E[x]²)``, so every rank normalizes
    alike and the running statistics equal the one-device step's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if active_data_shard() is not None:
            return self._global_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y

    def _global_forward(self, x):
        dims = (0, 2, 3)
        count = x.shape[0] * x.shape[2] * x.shape[3]
        sums = global_sum(torch.stack([x.sum(dim=dims),
                                       (x * x).sum(dim=dims)]))
        n = count * active_data_shard().count
        mean, mean2 = sums[0] / n, sums[1] / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (1, -1, 1, 1)
        y = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y


def _dropout(h, rate: float, training: bool, generator):
    """flax ``nn.Dropout`` (nn/layers.py ``dropout``) in training mode."""
    return dropout(h, rate, not training, generator)


class _ConvFeatures(nn.Module):
    """The FP CNN feature stack; NHWC in, (B, H/4 · W/4 · 64) out."""

    def __init__(self, input_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(input_channels, 32, generator)
        self.bn1 = _BatchNorm(32, eps=1e-5, momentum=0.1)
        self.conv2 = _conv(32, 64, generator)
        self.bn2 = _BatchNorm(64, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 2)
        x = F.max_pool2d(F.relu(self.bn2(self.conv2(x))), 2)
        x = x.permute(0, 2, 3, 1)  # back to NHWC: (H, W, C) feature order
        return x.reshape(x.shape[0], -1)


class ATQImageClassifier(nn.Module):
    """ATQ classifier. ``image_size`` fixes the head's input width
    (64 · (image_size // 4)^2; 3136 at 28). Built in eval mode."""

    def __init__(self, num_classes: int = 10, input_channels: int = 1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 hidden_size: int = 128, grad_mode: str = "parity",
                 dropout_rate: float = 0.3, image_size: int = 28,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        in_features = 64 * (image_size // 4) ** 2
        self.dropout_rate = dropout_rate
        self.features = _ConvFeatures(input_channels, generator)
        if use_rpb:
            self.classifier_0 = ResidualPrecisionBoostLinear(
                in_features, hidden_size, precision_ratio=0.05,
                sparsity_target=sparsity_target, grad_mode=grad_mode,
                device="cpu", generator=generator)
            self.classifier_3 = ResidualPrecisionBoostLinear(
                hidden_size, num_classes, precision_ratio=0.1,
                sparsity_target=sparsity_target, grad_mode=grad_mode,
                device="cpu", generator=generator)
        else:
            self.classifier_0 = TernaryLinear(
                in_features, hidden_size, grad_mode=grad_mode, device="cpu",
                generator=generator)
            self.classifier_3 = TernaryLinear(
                hidden_size, num_classes, grad_mode=grad_mode, device="cpu",
                generator=generator)
        self.to(dev)
        self.eval()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """Logits for NHWC images; ``generator`` drives dropout in train
        mode."""
        features = self.features(x)
        features = apply_selective_routing(features, threshold=0.05,
                                           importance_factor=0.7)
        h = F.relu(self.classifier_0(features))
        h = _dropout(h, self.dropout_rate, self.training, generator)
        return self.classifier_3(h)


class BaselineCNNClassifier(nn.Module):
    """The full-precision co-trained teacher: the same feature stack, then
    Dense(hidden) + ReLU + dropout + Dense(classes). Built in eval mode."""

    def __init__(self, num_classes: int = 10, input_channels: int = 1,
                 hidden_size: int = 128, dropout_rate: float = 0.3,
                 image_size: int = 28, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.features = _ConvFeatures(input_channels, generator)
        self.fc1 = _dense(64 * (image_size // 4) ** 2, hidden_size, generator)
        self.fc2 = _dense(hidden_size, num_classes, generator)
        self.to(dev)
        self.eval()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = F.relu(self.fc1(self.features(x)))
        h = _dropout(h, self.dropout_rate, self.training, generator)
        return self.fc2(h)
