"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: the port is built for the card, and a caller
    that wants the CPU (the tests, the plain reference path) says so with
    ``device="cpu"``. A CUDA request on a host without a GPU raises rather
    than carrying on silently on the CPU.

    On CUDA, TF32 is switched off for matmuls and cuDNN convolutions: the
    JAX reference computes in float32, and cuDNN would otherwise run the
    convolutions in TF32 by default.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "atq_tpu_torch: CUDA requested (the default) but no GPU is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
