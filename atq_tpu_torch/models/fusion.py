"""Multimodal fusion (port of atq_tpu/models/fusion.py).

- :class:`ModalitySpecificQuantization`: an ATQ projection, LayerNorm and
  exact GELU, with the per-modality sparsity targets hard-coded as in JAX
  (image 0.3, text 0.2, fusion 0.15, anything else 0.25).
- :class:`MultimodalFusion`: each modality projected, scaled by a learnable
  factor clamped to [0.5, 2], then fused by ``fusion_method``:
  'cross_attention' (text attends to image and image to text through
  :class:`TernaryCrossAttention`, RPB alignment projections, L2
  normalization, concatenation and a final projection), 'concat', or the
  element-wise gate (whose output_dim-wide gate is read only in its first
  len(modalities) columns, the JAX quirk). Then LayerNorm, dropout and L2
  normalization.

Submodule and parameter names are the flax ones (``modality_projections_
image``, ``modality_scales_text``, ``text2image``, ``final_fusion``, ...),
so the 'quant' paths the schedules read (core/schedules.py) and the
checkpoint layout (utils/jax_interop.py) match the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.nn.attention import (
    LayerNorm32,
    TernaryCrossAttention,
    _proj,
)
from atq_tpu_torch.nn.layers import dropout
from atq_tpu_torch.utils.platform import resolve_device

MODALITY_SPARSITY = {"image": 0.3, "text": 0.2, "fusion": 0.15}
DEFAULT_MODALITY_SPARSITY = 0.25


def l2_normalize(x, dim: int = 1, eps: float = 1e-12):
    """``x / max(||x||, eps)`` (torch ``F.normalize`` semantics)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class ModalitySpecificQuantization(nn.Module):
    def __init__(self, in_features: int, output_dim: int, modality_name: str,
                 use_rpb: bool = True, grad_mode: str = "parity", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        target = MODALITY_SPARSITY.get(modality_name,
                                       DEFAULT_MODALITY_SPARSITY)
        ratio = 0.2 if modality_name == "fusion" else 0.15
        self.projection = _proj(use_rpb, in_features, output_dim, ratio,
                                min(0.1, target), grad_mode, dtype,
                                generator=generator)
        self.norm = LayerNorm32(output_dim)

    def forward(self, x):
        return F.gelu(self.norm(self.projection(x)))


class MultimodalFusion(nn.Module):
    """Fusion of ``{modality: (B, input_dims[modality])}`` features into a
    joint L2-normalized (B, output_dim) embedding. Any method other than
    'cross_attention' and 'concat' is the element-wise gate, as in JAX."""

    def __init__(self, input_dims: Dict[str, int], output_dim: int,
                 fusion_method: str = "cross_attention", num_heads: int = 4,
                 dropout: float = 0.1, use_rpb: bool = True,
                 grad_mode: str = "parity", dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dims = dict(input_dims)
        self.fusion_method = fusion_method
        self.dropout = dropout
        initial_sparsity = 0.05  # the fusion starts very low, as in JAX
        n = len(self.input_dims)
        for name, dim in self.input_dims.items():
            setattr(self, f"modality_projections_{name}",
                    ModalitySpecificQuantization(
                        dim, output_dim, name, use_rpb, grad_mode, dtype,
                        generator=generator))
            setattr(self, f"modality_scales_{name}",
                    nn.Parameter(torch.ones(1)))

        def proj(in_features):
            return _proj(use_rpb, in_features, output_dim, 0.2,
                         initial_sparsity, grad_mode, dtype,
                         generator=generator)

        self.cross = (fusion_method == "cross_attention"
                      and {"text", "image"} <= set(self.input_dims))
        if self.cross:
            for name in ("text2image", "image2text"):
                setattr(self, name, TernaryCrossAttention(
                    output_dim, num_heads=num_heads, dropout=dropout,
                    use_rpb=use_rpb, sparsity_target=initial_sparsity,
                    grad_mode=grad_mode, dtype=dtype, device="cpu",
                    generator=generator))
            if use_rpb:
                self.cross_modal_align_text = proj(output_dim)
                self.cross_modal_align_image = proj(output_dim)
            self.final_fusion = proj(2 * output_dim)
        elif fusion_method == "concat":
            self.fusion_layer = proj(n * output_dim)
        else:
            self.fusion_gate = proj(n * output_dim)
        self.norm = LayerNorm32(output_dim)
        self.to(resolve_device(device))

    def forward(self, inputs: Dict[str, torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        for name in self.input_dims:
            if name not in inputs:
                raise ValueError(
                    f"Required modality '{name}' not found in inputs")
        projected = {}
        for name in self.input_dims:
            features = inputs[name]
            if features.ndim > 2:
                features = features.reshape(features.shape[0], -1)
            features = getattr(self, f"modality_projections_{name}")(
                features)
            scale = getattr(self, f"modality_scales_{name}")
            projected[name] = features * torch.clamp(scale, 0.5, 2.0)

        if self.cross:
            text, image = projected["text"], projected["image"]
            text_attended = self.text2image(text, image, image,
                                            deterministic=deterministic,
                                            generator=generator)
            image_attended = self.image2text(image, text, text,
                                             deterministic=deterministic,
                                             generator=generator)
            if hasattr(self, "cross_modal_align_text"):
                text_attended = self.cross_modal_align_text(text_attended)
                image_attended = self.cross_modal_align_image(image_attended)
            combined = torch.cat([l2_normalize(text_attended),
                                  l2_normalize(image_attended)], dim=1)
            fused = self.final_fusion(combined)
        elif self.fusion_method == "concat":
            fused = self.fusion_layer(torch.cat(
                [projected[n] for n in self.input_dims], dim=1))
        else:
            feats = [projected[n] for n in self.input_dims]
            gates = torch.sigmoid(self.fusion_gate(torch.cat(feats, dim=1)))
            fused = sum(gates[:, i:i + 1] * f for i, f in enumerate(feats))

        fused = dropout(self.norm(fused), self.dropout, deterministic,
                        generator)
        return l2_normalize(fused)
