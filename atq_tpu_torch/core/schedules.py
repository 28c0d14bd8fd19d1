"""Mixed-precision allocation and gradual quantization schedules (port of
atq_tpu/core/schedules.py).

The JAX package computes a new 'quant' collection each epoch; the port
writes the same values into the ``sparsity_target`` buffers of a model in
place. Each buffer is named by its flax path: the module's dotted name with
'/' separators (``text_encoder/layers_0/self_attn/q_proj``,
``fusion/modality_projections_image/projection``), the path the JAX
collection uses, since the port's module names are the flax names
(utils/jax_interop.py). So the keyword heuristics, the "'vision' iff
'image' in the path" rule and a sparsity plan's keys read the same strings
in both packages. Each value is written as the float32 JAX writes, into
every element of the buffer (a scanned stack's (L,) buffer included).

- :func:`epoch_progress`: ``min(1, epoch / (0.8 · total))``;
- :func:`set_quant_sparsity`: the model's own cascade,
  ``initial + progress · (target − initial)`` for each planned layer;
- :class:`MixedPrecisionATQ`: layer importance by keyword (2.0 / 1.5 / 0.8),
  ``sparsity = max(0.1, base / importance)`` ramped from
  ``min(0.1, final)`` by the epoch progress, for every RPB layer;
- :class:`GradualQuantizationScheduler`: the 3-phase warmup / linear ramp /
  plateau tables, then the cascade, then the importance walk.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

CRITICAL_KEYWORDS = ("fusion", "cross_attention", "projector", "final")
MEDIUM_KEYWORDS = ("attention", "embed", "pool")
LOW_KEYWORDS = ("intermediate", "ffn", "conv")


def sparsity_buffers(model: torch.nn.Module
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(flax path, buffer)`` for every ``sparsity_target`` buffer."""
    for name, buf in model.named_buffers():
        *mod, leaf = name.split(".")
        if leaf == "sparsity_target":
            yield "/".join(mod), buf


@torch.no_grad()
def _write(buf: torch.Tensor, value: float) -> None:
    buf.fill_(float(np.float32(value)))


class MixedPrecisionATQ:
    """Importance-driven precision and sparsity allocation."""

    @staticmethod
    def get_layer_importance(layer_name: str,
                             default_importance: float = 1.0) -> float:
        if any(k in layer_name for k in CRITICAL_KEYWORDS):
            return 2.0
        if any(k in layer_name for k in MEDIUM_KEYWORDS):
            return 1.5
        if any(k in layer_name for k in LOW_KEYWORDS):
            return 0.8
        return default_importance

    @staticmethod
    def get_precision_ratio(importance: float, base_ratio: float = 0.05,
                            max_ratio: float = 0.25) -> float:
        return min(max_ratio, base_ratio * importance)

    @staticmethod
    def get_sparsity_target(importance: float, base_sparsity: float = 0.3,
                            min_sparsity: float = 0.1) -> float:
        return max(min_sparsity, base_sparsity / importance)

    @classmethod
    def calculate_quantization_params(
        cls, layer_name: str, epoch: int, total_epochs: int,
        target_sparsity: float, initial_ratio: float = 0.05,
    ) -> Tuple[float, float]:
        importance = cls.get_layer_importance(layer_name)
        precision_ratio = cls.get_precision_ratio(importance,
                                                  base_ratio=initial_ratio)
        final_sparsity = cls.get_sparsity_target(importance,
                                                 base_sparsity=target_sparsity)
        progress = min(1.0, epoch / (total_epochs * 0.8))
        initial_sparsity = min(0.1, final_sparsity)
        current_sparsity = initial_sparsity + progress * (
            final_sparsity - initial_sparsity)
        return precision_ratio, current_sparsity

    @classmethod
    def update_model_quantization(
        cls, model: torch.nn.Module, epoch: int, total_epochs: int,
        vision_threshold: float = 0.3, text_threshold: float = 0.2,
    ) -> None:
        """Recompute every ``sparsity_target`` from its layer's importance
        and the epoch progress. A layer is 'vision' iff 'image' appears in
        its path."""
        for path, buf in sparsity_buffers(model):
            threshold = vision_threshold if "image" in path else text_threshold
            _, current = cls.calculate_quantization_params(
                path, epoch, total_epochs, threshold)
            _write(buf, current)


def set_quant_sparsity(model: torch.nn.Module,
                       plan: Dict[str, Tuple[float, float]],
                       progress_ratio: float) -> None:
    """The model's own sparsity cascade: each layer whose path is a key of
    ``plan`` (``path -> (initial, target)``) gets
    ``initial + progress · (target − initial)``; the rest keep theirs."""
    for path, buf in sparsity_buffers(model):
        if path in plan:
            initial, target = plan[path]
            _write(buf, initial + progress_ratio * (target - initial))


def epoch_progress(epoch: int, total_epochs: int) -> float:
    """``min(1, epoch / (0.8 · total))``, the reference's progress rule."""
    return min(1.0, epoch / (total_epochs * 0.8))


class GradualQuantizationScheduler:
    """3-phase per-epoch sparsity schedule (warmup / linear ramp /
    plateau); :meth:`step` writes an epoch's values into a model."""

    def __init__(self, total_epochs: int, vision_sparsity: float = 0.3,
                 text_sparsity: float = 0.2, warmup_epochs: int = 5,
                 final_epochs: Optional[int] = None, verbose: bool = False):
        self.total_epochs = total_epochs
        self.vision_sparsity = vision_sparsity
        self.text_sparsity = text_sparsity
        self.warmup_epochs = warmup_epochs
        self.final_epochs = final_epochs or max(2, int(total_epochs * 0.2))
        self.verbose = verbose
        self.initial_vision_sparsity = 0.05
        self.initial_text_sparsity = 0.05
        self.vision_sparsity_schedule = self._create_schedule(
            self.initial_vision_sparsity, self.vision_sparsity)
        self.text_sparsity_schedule = self._create_schedule(
            self.initial_text_sparsity, self.text_sparsity)

    def _create_schedule(self, initial_value: float,
                         final_value: float) -> List[float]:
        schedule = [initial_value] * self.warmup_epochs
        gradual = self.total_epochs - self.warmup_epochs - self.final_epochs
        for i in range(gradual):
            progress = (i + 1) / gradual
            schedule.append(initial_value + progress * (final_value
                                                        - initial_value))
        schedule.extend([final_value] * self.final_epochs)
        return schedule

    def scheduled_values(self, epoch: int) -> Tuple[float, float]:
        if epoch >= len(self.vision_sparsity_schedule):
            return self.vision_sparsity, self.text_sparsity
        return (self.vision_sparsity_schedule[epoch],
                self.text_sparsity_schedule[epoch])

    def step(self, model: torch.nn.Module, epoch: int,
             sparsity_plan: Optional[Dict[str, Tuple[float, float]]] = None
             ) -> None:
        """The model's cascade first, then the importance walk over every
        RPB layer, as the reference orders them."""
        vision, text = self.scheduled_values(epoch)
        if sparsity_plan:
            set_quant_sparsity(model, sparsity_plan,
                               epoch_progress(epoch, self.total_epochs))
        MixedPrecisionATQ.update_model_quantization(
            model, epoch, self.total_epochs, vision_threshold=vision,
            text_threshold=text)
        if self.verbose:
            print(f"Epoch {epoch + 1}: Vision sparsity = {vision:.3f}, "
                  f"Text sparsity = {text:.3f}")
