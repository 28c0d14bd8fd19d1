"""Generic JSON-driven multimodal dataset (port of
atq_tpu/data/multimodal_dataset.py, which no command-line tool calls; part
of the public API).

Items: ``{"image": filename, "text": str, "label": optional int}``; images
are read with PIL as float32 HWC in [0, 1] (or through
``image_transform``), texts whitespace-tokenized against a provided vocab
with PAD/UNK handling. Each item is a dict of numpy values.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np


class MultimodalDataset:
    def __init__(self, image_dir: str, text_file: str,
                 vocab: Optional[Dict[str, int]] = None,
                 max_length: int = 100,
                 image_transform: Optional[Callable] = None):
        self.image_dir = image_dir
        self.vocab = vocab
        self.max_length = max_length
        self.image_transform = image_transform
        with open(text_file, "r") as f:
            self.data = json.load(f)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> dict:
        item = self.data[idx]

        from PIL import Image

        image_path = os.path.join(self.image_dir, item["image"])
        with Image.open(image_path) as im:
            image = im.convert("RGB")
            if self.image_transform:
                image = self.image_transform(image)
            else:
                image = np.asarray(image, np.float32) / 255.0

        text = item["text"]
        if self.vocab is not None:
            tokens = text.split()
            token_ids = [self.vocab.get(t, self.vocab["<UNK>"])
                         for t in tokens]
            if len(token_ids) > self.max_length:
                token_ids = token_ids[:self.max_length]
            else:
                token_ids += [self.vocab["<PAD>"]] * (
                    self.max_length - len(token_ids)
                )
            text_tensor = np.asarray(token_ids, np.int64)
            text_length = min(len(tokens), self.max_length)
        else:
            text_tensor = text
            text_length = len(text.split())

        label = item.get("label", -1)
        return {
            "image": image,
            "text": text_tensor,
            "text_length": text_length,
            "label": np.int64(label) if label != -1 else None,
        }
