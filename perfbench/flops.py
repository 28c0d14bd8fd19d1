"""The yardstick's arithmetic: work a step needs, and the card's peaks.

Peaks are NVIDIA's H100 SXM data sheet's, dense, at its 700 W limit: 989
TFLOP/s in bf16 on the tensor cores, 495 in TF32, 3.35 TB/s of HBM. A
run prints the card's ``power.limit`` beside its numbers.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12


def analytic_step_flops(embed: int, ffn: int, layers: int, seq: int,
                        batch: int, classes: int) -> float:
    """Matmul FLOPs of one training step (fwd + bwd = 3 x forward): per
    layer 4 E^2 (q, k, v, out) and 2 E F (FFN) over B*S tokens, the
    2 B S^2 E attention pair, then the head. Remat's recompute and
    elementwise work are not counted. (A copy of
    atq_tpu_torch/train/scale.py ``analytic_step_flops``.)"""
    tokens = batch * seq
    per_layer = (2 * tokens * (4 * embed * embed + 2 * embed * ffn)
                 + 4 * batch * seq * seq * embed)
    return 3.0 * (layers * per_layer + 2 * batch * embed * classes)


def attention_work(batch: int, heads: int, seq: int, head_dim: int,
                   layers: int, elem_bytes: int) -> Tuple[float, float]:
    """``(operations, bytes)`` the step's attention needs, each layer once:
    the forward's two products 4 B H S^2 D and the backward's four (dV,
    dP, dQ, dK) 8 B H S^2 D; q, k, v, o, dO, dq, dk and dv each read or
    written once."""
    bhsd = batch * heads * seq * head_dim
    return 12.0 * bhsd * seq * layers, 8.0 * bhsd * elem_bytes * layers


def roofline_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The least time the work can take: the larger of its two bounds."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)
