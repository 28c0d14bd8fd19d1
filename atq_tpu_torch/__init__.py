"""PyTorch/CUDA port of ATQ: classification serving and training.

A second package beside ``atq_tpu`` (the JAX reference, left untouched).
It mirrors the JAX package's module paths (``core``, ``ops``, ``nn``,
``models``, ``data``, ``train``, ``serve``) and imports only ``torch`` and
``numpy``: never ``jax`` nor anything under ``atq_tpu``. The TPU kernels on
these paths (the order-statistic threshold, the packed 2-bit ternary matmul
and the fused ternarize+blend matmul's forward, dx and dW/dalpha) are
hand-written CUDA kernels for Hopper (``csrc/``), built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device requested and no GPU present they raise instead of
quietly running on the CPU (``utils.platform.resolve_device``).
"""

__version__ = "0.1.0"
