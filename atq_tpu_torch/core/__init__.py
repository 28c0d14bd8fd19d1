"""Quantizer, 2-bit packing and schedules (port of atq_tpu/core)."""

from atq_tpu_torch.core.packing import TernaryBitPacking
from atq_tpu_torch.core.quantize import (
    adaptive_ternary_quantization,
    ternarize_ste,
)
from atq_tpu_torch.core.schedules import (
    GradualQuantizationScheduler,
    MixedPrecisionATQ,
)

__all__ = [
    "adaptive_ternary_quantization",
    "ternarize_ste",
    "TernaryBitPacking",
    "GradualQuantizationScheduler",
    "MixedPrecisionATQ",
]
