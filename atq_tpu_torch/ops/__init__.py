"""CUDA kernel wrappers (port of atq_tpu/ops) and their build."""


def kernel_wrappers() -> dict:
    """Each CUDA kernel's wrapper, by kernel name. A wrapper's ``launches``
    count grows only where it launches its kernel on the card."""
    from atq_tpu_torch.ops import (
        fused_attention,
        fused_linear,
        order_stat,
        ternary_matmul,
    )

    return {
        "order_stat": order_stat.order_statistic_reductions,
        "batched_order_stat": order_stat.order_statistic_reductions_batched,
        "fused_attention_fwd": fused_attention.fused_attention_forward,
        "fused_attention_bwd": fused_attention.fused_attention_backward,
        "ternary_matmul": ternary_matmul.ternary_matmul_planar,
        "fused_forward": fused_linear.fused_linear_forward,
        "fused_dx": fused_linear.fused_linear_dx,
        "fused_dwda": fused_linear.fused_linear_dwda,
    }


def kernel_launches() -> dict:
    """Each CUDA kernel's launch count so far, by kernel name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
