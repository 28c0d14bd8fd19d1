"""Fashion-MNIST / MNIST image classifier with an ATQ head, eval path.

Port of atq_tpu/models/image_classifier.py (``_ConvFeatures`` and
``ATQImageClassifier``): a full-precision CNN feature stack
Conv(1->32, 3x3, pad 1) + BN + ReLU + MaxPool(2) twice, flattened to
64·7·7 = 3136 features for 28x28 inputs, identity selective routing, then
a two-layer quantized head (RPB with precision 0.05 / 0.1, or
TernaryLinear).

The public input is NHWC (B, H, W, C), as the JAX model takes it. The
convolutions run NCHW inside; the features are permuted back to NHWC before
the flatten, so the feature order is (H, W, C) as on the JAX side and the
head weights carry over with no column permutation. BatchNorm runs in eval
mode with eps 1e-5. Submodule names follow the flax names (``features``,
``conv1``, ``bn1``, ..., ``classifier_0``, ``classifier_3``), so a JAX
checkpoint maps onto the state dict name for name (utils/jax_interop.py).

The full-precision teacher (``BaselineCNNClassifier``) and the train-mode
path (dropout, batch statistics) come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.nn.initializers import (
    bias_uniform_torch_,
    kaiming_uniform_torch_,
)
from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    TernaryLinear,
    apply_selective_routing,
)
from atq_tpu_torch.utils.platform import resolve_device


def _conv(cin: int, cout: int, generator) -> nn.Conv2d:
    # Built on the meta device so that construction draws nothing from the
    # global RNG; every value comes from `generator`.
    conv = nn.Conv2d(cin, cout, 3, padding=1, device="meta").to_empty(
        device="cpu")
    kaiming_uniform_torch_(conv.weight.data, generator=generator)
    bias_uniform_torch_(conv.bias.data, cin * 9, generator=generator)
    return conv


class _ConvFeatures(nn.Module):
    """The FP CNN feature stack; NHWC in, (B, H/4 · W/4 · 64) out."""

    def __init__(self, input_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(input_channels, 32, generator)
        self.bn1 = nn.BatchNorm2d(32, eps=1e-5, momentum=0.1)
        self.conv2 = _conv(32, 64, generator)
        self.bn2 = nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 2)
        x = F.max_pool2d(F.relu(self.bn2(self.conv2(x))), 2)
        x = x.permute(0, 2, 3, 1)  # back to NHWC: (H, W, C) feature order
        return x.reshape(x.shape[0], -1)


class ATQImageClassifier(nn.Module):
    """ATQ classifier, eval forward. ``image_size`` fixes the head's input
    width (64 · (image_size // 4)^2; 3136 at 28)."""

    def __init__(self, num_classes: int = 10, input_channels: int = 1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 hidden_size: int = 128, grad_mode: str = "parity",
                 image_size: int = 28, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        in_features = 64 * (image_size // 4) ** 2
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

    def forward(self, x):
        features = self.features(x)
        features = apply_selective_routing(features, threshold=0.05,
                                           importance_factor=0.7)
        h = F.relu(self.classifier_0(features))
        return self.classifier_3(h)
