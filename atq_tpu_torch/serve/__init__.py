"""Serving stack (port of atq_tpu/serve); ``python -m atq_tpu_torch.serve``.

The exports are the JAX package's. Importing them builds and loads no
CUDA source: a kernel is built where it is first launched.
"""

from atq_tpu_torch.serve.aot import AOTServing, export_serving, load_serving
from atq_tpu_torch.serve.engine import BatchServer, pad_to_bucket, pick_bucket
from atq_tpu_torch.serve.index import EmbeddingIndex
from atq_tpu_torch.serve.packed_model import (
    PackedClassifier,
    pack_quantized_params,
    packed_linear_apply,
)

__all__ = [
    "AOTServing",
    "export_serving",
    "load_serving",
    "BatchServer",
    "EmbeddingIndex",
    "pad_to_bucket",
    "pick_bucket",
    "pack_quantized_params",
    "packed_linear_apply",
    "PackedClassifier",
]
