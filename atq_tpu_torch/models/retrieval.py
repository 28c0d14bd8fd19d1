"""Image-text retrieval model (port of atq_tpu/models/retrieval.py).

- :class:`ImageEncoder`: the float ResNet backbone (``base_model``) ->
  LayerNorm -> RPB projector -> exact GELU -> LayerNorm -> clamped scaling
  -> L2 normalize.
- :class:`ATQMultimodalRetrieval`: the image encoder, the ternary text
  encoder (with the ternary-expert MoE FFN when ``text_moe_experts > 0``),
  the cross-attention fusion (models/fusion.py), the text and
  image projectors with their LayerNorms and the learnable temperature.
  ``encode_image``/``encode_text`` give the L2-normalized embeddings that
  retrieval scores by cosine; ``forward`` gives the similarity matrix (with
  the extra image projector), or with ``return_embeddings`` the two
  embeddings, or with ``return_fused`` the fused embedding.

``compute_dtype`` (``--use_amp``: bfloat16) is the JAX model's: latent
weights, quantizer thresholds, LayerNorm, BatchNorm and softmax stay
float32; the effective weights and activations are cast at each matmul and
convolution. Both embeddings come out float32.

``forward(..., train=True)`` is flax's ``train`` flag: BatchNorm normalizes
with the batch statistics and moves its running statistics (the module is
put in training mode), and dropout is active, its masks drawn from the
caller's ``generator``.

Module names mirror the JAX ones (``image_encoder``, ``text_encoder``,
``fusion``, ``text_projector``, ``image_projector``, ``img_norm``,
``text_norm``, ``temperature``), so a JAX checkpoint maps onto the state
dict name for name (utils/jax_interop.py), every collection included.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.models.fusion import MultimodalFusion, l2_normalize
from atq_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    FEATURE_DIMS,
    ResNetFeatures,
)
from atq_tpu_torch.models.text_encoder import (
    ATQTextEncoder,
    sinusoidal_positional_encoding,
)
from atq_tpu_torch.nn.attention import LayerNorm32, _proj
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)
from atq_tpu_torch.utils.platform import resolve_device

_BACKBONES = {"resnet18": ((2, 2, 2, 2), BasicBlock),
              "resnet50": ((3, 4, 6, 3), Bottleneck)}


class ImageEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, use_rpb: bool = True,
                 sparsity_target: float = 0.3, base_model: str = "resnet18",
                 grad_mode: str = "parity", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if base_model not in _BACKBONES:
            raise ValueError(f"Unknown base model: {base_model}")
        initial_sparsity = min(0.1, sparsity_target)
        stages, block = _BACKBONES[base_model]
        self.base_model = ResNetFeatures(stages, block, device="cpu",
                                         generator=generator, dtype=dtype)
        feat = FEATURE_DIMS[base_model]
        self.feature_norm = LayerNorm32(feat)
        self.projector = _proj(use_rpb, feat, embed_dim, 0.2,
                               initial_sparsity, grad_mode, dtype,
                               generator=generator)
        self.proj_norm = LayerNorm32(embed_dim)
        self.scaling = nn.Parameter(torch.full((1,), 4.0))

    def forward(self, x):
        features = self.feature_norm(self.base_model(x))
        embeddings = F.gelu(self.projector(features))
        embeddings = self.proj_norm(embeddings)
        embeddings = embeddings * torch.clamp(self.scaling, 1.0, 10.0)
        return l2_normalize(embeddings, dim=1)


class ATQMultimodalRetrieval(nn.Module):
    """Joint image-text embedding model. Built in eval mode on ``device``
    (the GPU unless the caller asks for the CPU)."""

    def __init__(self, vocab_size: int = 10000, embed_dim: int = 256,
                 hidden_dim: int = 512, vision_threshold: float = 0.3,
                 text_threshold: float = 0.2, use_residual: bool = True,
                 base_model: str = "resnet18", grad_mode: str = "parity",
                 text_moe_experts: int = 0, text_scan_layers: bool = False,
                 text_attn_impl: str = "einsum", max_seq_length: int = 50,
                 dropout: float = 0.1, compute_dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        initial_vision = min(0.1, vision_threshold)
        initial_text = min(0.1, text_threshold)
        self.image_encoder = ImageEncoder(
            embed_dim=embed_dim, use_rpb=use_residual,
            sparsity_target=initial_vision, base_model=base_model,
            grad_mode=grad_mode, dtype=compute_dtype, generator=generator)
        self.text_encoder = ATQTextEncoder(
            vocab_size=vocab_size, embed_dim=embed_dim, num_heads=8,
            num_layers=4, dim_feedforward=hidden_dim, dropout=dropout,
            use_rpb=use_residual, sparsity_target=initial_text,
            max_seq_length=max_seq_length, grad_mode=grad_mode,
            moe_experts=text_moe_experts, scan_layers=text_scan_layers,
            attn_impl=text_attn_impl, dtype=compute_dtype, device="cpu",
            generator=generator)
        self.fusion = MultimodalFusion(
            {"image": embed_dim, "text": embed_dim}, embed_dim,
            fusion_method="cross_attention", num_heads=4,
            use_rpb=use_residual, grad_mode=grad_mode, dropout=dropout,
            dtype=compute_dtype, device="cpu", generator=generator)
        self.text_projector = _proj(use_residual, embed_dim, embed_dim, 0.2,
                                    initial_text, grad_mode, compute_dtype,
                                    generator=generator)
        self.image_projector = _proj(use_residual, embed_dim, embed_dim, 0.2,
                                     initial_vision, grad_mode, compute_dtype,
                                     generator=generator)
        self.img_norm = LayerNorm32(embed_dim)
        self.text_norm = LayerNorm32(embed_dim)
        self.temperature = nn.Parameter(torch.tensor(0.07))
        self.to(resolve_device(device))
        self.eval()

    def encode_image(self, image):
        return self.image_encoder(image)

    def encode_text(self, text, text_lengths=None,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    moe_aux: Optional[List[torch.Tensor]] = None):
        text_features = self.text_encoder(text, text_lengths,
                                          deterministic=deterministic,
                                          generator=generator,
                                          moe_aux=moe_aux)
        text_embeddings = self.text_norm(self.text_projector(text_features))
        return l2_normalize(text_embeddings, dim=1)

    def forward(self, image, text, text_lengths=None,
                return_embeddings: bool = False, return_fused: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                moe_aux: Optional[List[torch.Tensor]] = None):
        """``moe_aux``: a list that the text tower's MoE layers
        (``text_moe_experts > 0``) append their load-balance losses to."""
        if self.training != train:
            self.train(train)
        deterministic = not train
        image_embeddings = self.encode_image(image)
        text_embeddings = self.encode_text(text, text_lengths,
                                           deterministic, generator, moe_aux)
        if return_embeddings:
            return image_embeddings, text_embeddings
        if return_fused:
            return self.fusion({"image": image_embeddings,
                                "text": text_embeddings},
                               deterministic=deterministic,
                               generator=generator)
        image_embeddings = self.img_norm(self.image_projector(
            image_embeddings))
        image_embeddings = l2_normalize(image_embeddings, dim=1)
        return torch.matmul(image_embeddings,
                            text_embeddings.T) / self.temperature

    def load_jax_variables(self, variables: Dict) -> None:
        """Load JAX-layout variables (``params``, ``quant``,
        ``batch_stats``, ``constants``; numpy leaves). A checkpoint without
        ``constants`` gets the sinusoidal table, as serve.py takes it from
        a fresh init."""
        variables = {k: v for k, v in variables.items()
                     if isinstance(v, dict)}
        if not variables.get("constants"):
            pe = self.text_encoder.positional_encoding
            variables["constants"] = {"text_encoder": {
                "positional_encoding": sinusoidal_positional_encoding(
                    pe.shape[1], pe.shape[2])}}
        self.load_state_dict(from_jax_variables(variables))

    def jax_variables(self) -> Dict:
        """Inverse of :meth:`load_jax_variables`: JAX-layout variables."""
        return to_jax_variables(self.state_dict())


def modality_dropout_flags(generator: Optional[torch.Generator] = None,
                           rate: float = 0.1):
    """Per-batch modality-drop decisions ``(drop_image, drop_text)``, each
    true with probability ``rate``, drawn from ``generator``. As in the
    JAX package (and the reference it follows), the retrieval model sets
    these flags but its forward never reads them; the legacy classifier
    (models/legacy.py) does."""
    u = torch.rand(2, generator=generator)
    return bool(u[0] < rate), bool(u[1] < rate)


def get_model_size_info(params: dict, use_rpb: bool = True) -> dict:
    """Parameter counts per component of a JAX-layout param tree and the
    reference's estimated ternarized memory (75% of parameters at 2 bits
    with RPB, 90% without)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return int(np.prod(np.shape(tree)))

    components = ("image_encoder", "text_encoder", "text_projector",
                  "image_projector", "fusion")
    counts = {f"{k}_parameters": count(params.get(k, {}))
              for k in components}
    total = sum(counts.values())
    if use_rpb:
        memory_bytes = total * 0.75 * 2 / 8 + total * 0.25 * 4
    else:
        memory_bytes = total * 0.9 * 2 / 8 + total * 0.1 * 4
    return {"total_parameters": total, **counts,
            "estimated_memory_usage_MB": memory_bytes / (1024 * 1024)}
