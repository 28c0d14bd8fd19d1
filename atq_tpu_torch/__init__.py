"""PyTorch/CUDA port of ATQ.

A second package beside ``atq_tpu`` (the JAX reference, left untouched).
It mirrors the JAX package's module paths (``core``, ``ops``, ``nn``,
``models``, ``data``, ``parallel``, ``losses``, ``train``, ``serve``,
``utils``) and their exports, and imports only ``torch`` and ``numpy``:
never ``jax`` nor anything under ``atq_tpu``. The TPU kernels (the
order-statistic threshold, the packed 2-bit ternary matmul, the fused
ternarize+blend matmul's forward, dx and dW/dalpha, and the fused
attention) are hand-written CUDA kernels for Hopper (``csrc/``), built at
their first launch, never at import.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device requested and no GPU present they raise instead of
quietly running on the CPU (``utils.platform.resolve_device``).
"""

__version__ = "0.1.0"

from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.nn.layers import (
    ResidualPrecisionBoostLinear,
    SelectiveGradientRouting,
    TernaryLinear,
    apply_selective_routing,
    selective_gradient_routing,
)

__all__ = [
    "adaptive_ternary_quantization",
    "TernaryLinear",
    "ResidualPrecisionBoostLinear",
    "apply_selective_routing",
    "selective_gradient_routing",
    "SelectiveGradientRouting",
]
