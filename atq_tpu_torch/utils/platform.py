"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: the port is built for the card, and a caller
    that wants the CPU (the tests, the plain reference path) says so with
    ``device="cpu"``. A CUDA request on a host without a GPU raises rather
    than carrying on silently on the CPU.

    Under torchrun (``LOCAL_RANK`` set) "cuda" is the rank's own card,
    ``cuda:LOCAL_RANK``, made the current device.

    On CUDA, TF32 is switched off for matmuls and cuDNN convolutions: the
    JAX reference computes in float32, and cuDNN would otherwise run the
    convolutions in TF32 by default. And the run repeats bit for bit, as
    the reference's does on its TPU (:func:`deterministic_backends`).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "atq_tpu_torch: CUDA requested (the default) but no GPU is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        deterministic_backends()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def deterministic_backends() -> None:
    """cuDNN on algorithms that repeat bit for bit, chosen without
    benchmarking. Its default filter gradient of a float32 convolution
    sums in no fixed order, so a trained checkpoint would differ from one
    run to the next. The port's own kernels repeat."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
