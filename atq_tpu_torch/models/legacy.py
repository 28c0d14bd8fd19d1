"""Legacy multimodal classifier (port of atq_tpu/models/legacy.py, which
no command-line tool calls; part of the public API).

Dual classifier paths, a quantized RPB stack and a full-precision stack,
blended by a learnable sigmoid mix ratio (init 0.8). The image branch is
the classifier's CNN feature stack (NHWC 28x28 in, 64·7·7 out), the text
branch a 2-layer ternary text encoder, and the two meet in the
cross-attention fusion. Modality dropout is explicit: ``drop_image`` /
``drop_text`` zero that modality's features. ``MultimodalATQ`` is an alias.

Module names are the JAX ones (``image_encoder_features``,
``text_encoder``, ``fusion``, ``classifier_0``/``classifier_3``,
``full_classifier_0``/``full_classifier_3``, ``mix_ratio``), so
utils/jax_interop.py carries a JAX init across. Built in eval mode;
``forward(..., train=True)`` is flax's ``train`` (batch statistics,
dropout from the caller's ``generator``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.models.fusion import MultimodalFusion
from atq_tpu_torch.models.image_classifier import _ConvFeatures, _dense
from atq_tpu_torch.models.text_encoder import ATQTextEncoder
from atq_tpu_torch.nn.attention import _proj
from atq_tpu_torch.nn.layers import apply_selective_routing, dropout
from atq_tpu_torch.utils.platform import resolve_device

IMAGE_FEATURE_DIM = 64 * 7 * 7  # 28x28 input after two 2x2 pools


class ATQMultimodalClassifier(nn.Module):
    def __init__(self, num_classes: int = 10, vocab_size: int = 10000,
                 embed_dim: int = 128, hidden_dim: int = 256,
                 fusion_method: str = "cross_attention",
                 vision_threshold: float = 0.05, text_threshold: float = 0.05,
                 fusion_threshold: float = 0.05, use_residual: bool = True,
                 residual_scale: float = 0.1, grad_mode: str = "parity",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        initial_fusion = min(0.01, fusion_threshold)
        self.image_encoder_features = _ConvFeatures(1, generator)
        self.text_encoder = ATQTextEncoder(
            vocab_size=vocab_size, embed_dim=embed_dim, num_heads=4,
            num_layers=2, dim_feedforward=hidden_dim, use_rpb=use_residual,
            sparsity_target=min(0.01, text_threshold), grad_mode=grad_mode,
            device="cpu", generator=generator)
        self.fusion = MultimodalFusion(
            {"image": IMAGE_FEATURE_DIM, "text": embed_dim}, hidden_dim,
            fusion_method=fusion_method, use_rpb=use_residual,
            grad_mode=grad_mode, device="cpu", generator=generator)
        self.classifier_0 = _proj(use_residual, hidden_dim, hidden_dim // 2,
                                  0.2, initial_fusion, grad_mode,
                                  generator=generator)
        self.classifier_3 = _proj(use_residual, hidden_dim // 2, num_classes,
                                  0.2, initial_fusion, grad_mode,
                                  generator=generator)
        self.full_classifier_0 = _dense(hidden_dim, hidden_dim // 2,
                                        generator)
        self.full_classifier_3 = _dense(hidden_dim // 2, num_classes,
                                        generator)
        self.mix_ratio = nn.Parameter(torch.tensor(0.8))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, image, text, text_padding_mask=None,
                drop_image: bool = False, drop_text: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.training != train:
            self.train(train)
        deterministic = not train
        image_features = self.image_encoder_features(image)
        if drop_image:
            image_features = torch.zeros_like(image_features)
        text_features = self.text_encoder(text, text_padding_mask,
                                          deterministic=deterministic,
                                          generator=generator)
        if drop_text:
            text_features = torch.zeros_like(text_features)
        fused = self.fusion({"image": image_features, "text": text_features},
                            deterministic=deterministic, generator=generator)
        fused_routed = apply_selective_routing(fused, threshold=0.01)

        h = F.gelu(self.classifier_0(fused_routed))
        h = dropout(h, 0.2, deterministic, generator)
        quant_logits = self.classifier_3(h)

        f = F.gelu(self.full_classifier_0(fused))
        f = dropout(f, 0.2, deterministic, generator)
        full_logits = self.full_classifier_3(f)

        mix = torch.sigmoid(self.mix_ratio)
        return mix * quant_logits + (1.0 - mix) * full_logits


# Alias for backward compatibility.
MultimodalATQ = ATQMultimodalClassifier
