"""Quantized layers, attention and the transformer stack (port of
atq_tpu/nn). JAX's remat policies ``quantized_weight_policy`` and
``quantized_weight_and_dots_policy`` are the scanned stack's
``remat_policy`` values here, 'save_quantized' and 'save_dots'
(``REMAT_POLICIES``)."""

from atq_tpu_torch.nn.attention import (
    TernaryCrossAttention,
    TernaryMultiheadAttention,
)
from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    TernaryLinear,
    apply_selective_routing,
    selective_gradient_routing,
)
from atq_tpu_torch.nn.transformer import (
    REMAT_POLICIES,
    ScannedTernaryStack,
    TernaryTransformerLayer,
    stack_layer_params,
    unstack_layer_params,
)

__all__ = [
    "TernaryLinear",
    "ResidualPrecisionBoostLinear",
    "apply_selective_routing",
    "selective_gradient_routing",
    "REMAT_POLICIES",
    "TernaryMultiheadAttention",
    "TernaryCrossAttention",
    "ScannedTernaryStack",
    "TernaryTransformerLayer",
    "stack_layer_params",
    "unstack_layer_params",
]
