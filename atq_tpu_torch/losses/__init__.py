"""Contrastive losses (port of atq_tpu/losses)."""

from atq_tpu_torch.losses.contrastive import (
    ContrastiveLearningManager,
    HardNegativeMiningInfoNCE,
    MultiPositiveInfoNCE,
)

__all__ = [
    "HardNegativeMiningInfoNCE",
    "MultiPositiveInfoNCE",
    "ContrastiveLearningManager",
]
