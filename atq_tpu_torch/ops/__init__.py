"""CUDA kernel wrappers (port of atq_tpu/ops) and their build.

Importing this package registers the ops that stand for the kernels an
eval forward reaches, so that ``torch.export`` keeps each as one node and
a saved program (serve/aot.py) finds them when it loads:
``torch.ops.atq_tpu_torch.order_stat`` (ops/order_stat.py),
``ternary_matmul``, ``ternary_matmul32``, ``ternary_matmul_rpb``
(ops/ternary_matmul.py) and ``fused_forward`` (ops/fused_linear.py). Each
op's CUDA implementation launches its kernel through ``ctypes`` and its
CPU implementation is the kernel's plain PyTorch version. Each op that
does products has a FLOP formula for ``FlopCounterMode``.
"""


def matmul_flops(m: int, n: int, k: int, products: int = 1) -> int:
    """``products`` (M, K) x (K, N) products, 2·M·N·K each: a kernel's work
    as ``FlopCounterMode`` counts its plain version (one ``torch.matmul``
    a product)."""
    return 2 * m * n * k * products


def kernel_wrappers() -> dict:
    """Each CUDA kernel's wrapper, by kernel name. A wrapper's ``launches``
    count grows only where it launches its kernel on the card. Its
    ``flops`` count grows there by the work of the launch, what
    ``FlopCounterMode`` counts for its plain version at the same shapes
    (utils/flops.py ``counted_flops``), except behind a registered op:
    the op's FLOP formula lets the counter count it on either device, and
    the wrapper's ``flops`` stays 0."""
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
        "ternary_matmul32": ternary_matmul.ternary_matmul_planar32,
        "ternary_matmul_rpb": ternary_matmul.ternary_matmul_rpb,
        "fused_forward": fused_linear.fused_linear_forward,
        "fused_dx": fused_linear.fused_linear_dx,
        "fused_dwda": fused_linear.fused_linear_dwda,
    }


def kernel_launches() -> dict:
    """Each CUDA kernel's launch count so far, by kernel name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def kernel_flops() -> dict:
    """Each CUDA kernel's counted FLOPs so far, by kernel name."""
    return {name: fn.flops for name, fn in kernel_wrappers().items()}


# Registers the ops (the modules import matmul_flops from here, above).
from atq_tpu_torch.ops import (  # noqa: E402,F401
    fused_linear,
    order_stat,
    ternary_matmul,
)
from atq_tpu_torch.ops.fast_pool import fast_max_pool  # noqa: E402
from atq_tpu_torch.ops.ternary_matmul import (  # noqa: E402
    kernel_eligible,
    packed_ternary_matmul,
)

# The JAX package's exports (its pallas_eligible is kernel_eligible here),
# then the port's launch and FLOP counts.
__all__ = ["fast_max_pool", "packed_ternary_matmul", "kernel_eligible",
           "kernel_wrappers", "kernel_launches", "kernel_flops",
           "matmul_flops"]
