"""Data helpers (port of atq_tpu/data)."""

from atq_tpu_torch.data.flickr8k import (
    prepare_flickr8k_dataloaders,
    visualize_flickr8k_samples,
)
from atq_tpu_torch.data.mnist import get_fashion_mnist_data, get_mnist_data
from atq_tpu_torch.data.multimodal_dataset import MultimodalDataset
from atq_tpu_torch.data.text_utils import (
    build_vocabulary,
    clean_text,
    create_embedding_matrix,
    tokenize_texts,
)

__all__ = [
    "get_mnist_data",
    "get_fashion_mnist_data",
    "prepare_flickr8k_dataloaders",
    "visualize_flickr8k_samples",
    "MultimodalDataset",
    "build_vocabulary",
    "clean_text",
    "create_embedding_matrix",
    "tokenize_texts",
]
