"""PyTorch/CUDA port of the ATQ classification serving path.

A second package beside ``atq_tpu`` (the JAX reference, left untouched).
It mirrors the JAX package's module paths (``core``, ``ops``, ``nn``,
``models``, ``serve``) and imports only ``torch`` and ``numpy``: never
``jax`` nor anything under ``atq_tpu``. The two TPU kernels on the path
(the order-statistic threshold and the packed 2-bit ternary matmul) are
hand-written CUDA kernels for Hopper (``csrc/``), built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device requested and no GPU present they raise instead of
quietly running on the CPU (``utils.platform.resolve_device``).
"""

__version__ = "0.1.0"
