"""Models (port of atq_tpu/models)."""

from atq_tpu_torch.models.fusion import (
    ModalitySpecificQuantization,
    MultimodalFusion,
)
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.models.legacy import ATQMultimodalClassifier, MultimodalATQ
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval, ImageEncoder
from atq_tpu_torch.models.text_encoder import ATQTextEncoder

__all__ = [
    "ATQImageClassifier",
    "ATQTextEncoder",
    "MultimodalFusion",
    "ModalitySpecificQuantization",
    "ATQMultimodalRetrieval",
    "ImageEncoder",
    "ATQMultimodalClassifier",
    "MultimodalATQ",
]
