"""Contrastive losses for image-text retrieval (port of
atq_tpu/losses/contrastive.py).

- :class:`HardNegativeMiningInfoNCE`: bidirectional InfoNCE over the
  in-batch cosine similarity with a cosine-annealed temperature (2x base
  down to 0.5x base over the first 70 % of epochs, a host-side float per
  epoch), the top ``hardest_mining_ratio`` off-diagonal similarities of
  each row and each column up-weighted by ``1 + hard_negative_weight``
  (chosen on the detached similarity), and the entropy term ADDED with +λ,
  the JAX quirk.
- :class:`MultiPositiveInfoNCE`: a uniform target over each anchor's
  positives, the entropy term with −λ.
- :class:`ContrastiveLearningManager`: the three curriculum stages by epoch
  progress; :func:`curriculum_weights_traced` takes the stage's rule as a
  device tensor, so the train step reads no value on the host.

``torch.topk`` and ``jax.lax.top_k`` may choose different entries when
values tie at the k-th place; away from ties they choose the same set.
A ``temperature`` passed as a 0-d float32 tensor divides on the device as
JAX's traced scalar does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from atq_tpu_torch.models.fusion import l2_normalize


def _entropy_of_rows(similarity):
    p = torch.softmax(similarity, dim=1)
    logp = torch.log_softmax(similarity, dim=1)
    return -torch.mean(torch.sum(p * logp, dim=1))


def _cross_entropy_diag(logits):
    """Cross-entropy against the diagonal labels."""
    return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=1)))


def _similarity(image_embeddings, text_embeddings, temperature):
    return torch.matmul(l2_normalize(image_embeddings),
                        l2_normalize(text_embeddings).T) / temperature


class HardNegativeMiningInfoNCE:
    def __init__(self, temperature: float = 0.07, lambda_reg: float = 0.02,
                 hard_negative_weight: float = 0.5,
                 hardest_mining_ratio: float = 0.5,
                 temperature_schedule: bool = True):
        self.temperature = temperature
        self.base_temperature = temperature
        self.lambda_reg = lambda_reg
        self.hard_negative_weight = hard_negative_weight
        self.hardest_mining_ratio = hardest_mining_ratio
        self.temperature_schedule = temperature_schedule
        self.current_epoch = 0
        self.total_epochs = 1

    def set_epoch(self, current_epoch: int, total_epochs: int):
        self.current_epoch = current_epoch
        self.total_epochs = total_epochs

    def get_current_temperature(self) -> float:
        """The epoch's temperature, a host-side float."""
        if not self.temperature_schedule:
            return self.temperature
        progress = min(1.0, self.current_epoch / (self.total_epochs * 0.7))
        max_temp = self.base_temperature * 2.0
        min_temp = self.base_temperature * 0.5
        temperature = max_temp - (max_temp - min_temp) * (
            1 - math.cos(progress * math.pi)) / 2
        return max(min(temperature, max_temp), min_temp)

    def __call__(self, image_embeddings, text_embeddings,
                 weights: Optional[torch.Tensor] = None, temperature=None):
        if temperature is None:
            temperature = self.get_current_temperature()
        similarity = _similarity(image_embeddings, text_embeddings,
                                 temperature)
        batch = similarity.shape[0]
        eye = torch.eye(batch, dtype=similarity.dtype,
                        device=similarity.device)
        neg_mask = 1.0 - eye
        k = max(1, int(batch * self.hardest_mining_ratio))
        with torch.no_grad():
            diag = eye > 0
            idx_i2t = torch.topk(similarity.masked_fill(diag, -math.inf),
                                 k, dim=1).indices   # per image row
            idx_t2i = torch.topk(similarity.T.masked_fill(diag, -math.inf),
                                 k, dim=1).indices   # per text row
            hard_img = torch.zeros_like(similarity).scatter_(1, idx_i2t, 1.0)
            hard_txt = torch.zeros_like(similarity).scatter_(
                1, idx_t2i, 1.0).T                   # the transposed fill
            hard_neg_mask = ((hard_img + hard_txt) > 0).to(
                similarity.dtype) * neg_mask
            easy_neg_mask = neg_mask - hard_neg_mask
        pos_weights = (weights if weights is not None else torch.ones(
            batch, dtype=similarity.dtype, device=similarity.device))
        neg_weights = (easy_neg_mask
                       + hard_neg_mask * (1.0 + self.hard_negative_weight))
        weighted = (similarity * eye * pos_weights.reshape(-1, 1)
                    + similarity * neg_weights)
        image_loss = _cross_entropy_diag(weighted)
        text_loss = _cross_entropy_diag(weighted.T)
        # +λ: the sign quirk, kept.
        regularity = self.lambda_reg * (_entropy_of_rows(similarity)
                                        + _entropy_of_rows(similarity.T)) / 2
        return (image_loss + text_loss) / 2 + regularity


class MultiPositiveInfoNCE:
    def __init__(self, temperature: float = 0.07, lambda_reg: float = 0.02):
        self.temperature = temperature
        self.lambda_reg = lambda_reg

    def __call__(self, image_embeddings, text_embeddings, positive_mask,
                 temperature=None):
        if temperature is None:
            temperature = self.temperature
        similarity = _similarity(image_embeddings, text_embeddings,
                                 temperature)
        batch = similarity.shape[0]
        positive_mask = positive_mask.to(similarity.dtype)

        def target(dim):
            counts = positive_mask.sum(dim=dim, keepdim=True)
            return torch.where(counts > 0,
                               positive_mask / torch.clamp(counts, min=1.0),
                               torch.zeros((), dtype=similarity.dtype,
                                           device=similarity.device))

        i2t = -torch.sum(target(1) * torch.log_softmax(similarity, dim=1))
        t2i = -torch.sum(target(0) * torch.log_softmax(similarity, dim=0))
        # −λ here, the opposite sign from HardNegativeMiningInfoNCE.
        regularity = -self.lambda_reg * (_entropy_of_rows(similarity)
                                         + _entropy_of_rows(similarity.T)) / 2
        return (i2t / batch + t2i / batch) / 2 + regularity


class ContrastiveLearningManager:
    """Curriculum weighting around a criterion: the first stage weights
    easy positives sigmoid(10·sim), the last hard ones
    1 − sigmoid(10·sim − 5), those between uniformly."""

    def __init__(self, criterion, similarity_threshold: float = 0.8,
                 mining_freq: int = 50, curriculum_steps: int = 3):
        self.criterion = criterion
        self.similarity_threshold = similarity_threshold
        self.mining_freq = mining_freq
        self.curriculum_steps = curriculum_steps
        self.steps = 0
        self.mined_examples: list = []
        self.epoch = 0
        self.total_epochs = 0
        self.curriculum_stage = 0

    def set_epoch(self, epoch: int, total_epochs: int):
        self.epoch = epoch
        self.total_epochs = total_epochs
        progress = epoch / total_epochs
        self.curriculum_stage = min(self.curriculum_steps - 1,
                                    int(progress * self.curriculum_steps))

    def curriculum_kind(self) -> int:
        """The stage's weighting rule: 0 easy-positive (first stage),
        2 hard-positive (last stage), 1 uniform (between)."""
        if self.curriculum_stage == 0:
            return 0
        if self.curriculum_stage == self.curriculum_steps - 1:
            return 2
        return 1

    def get_curriculum_weight(self, similarity):
        return curriculum_weights_traced(similarity, self.curriculum_kind())

    @torch.no_grad()
    def mine_hard_examples(self, embed_fn, batches, max_examples: int = 1000):
        """Flat indices of the positives whose cosine similarity is below
        the threshold; ``embed_fn(batch) -> (image, text)`` embeds a
        batch."""
        hard_examples = []
        for batch_idx, batch in enumerate(batches):
            if len(hard_examples) >= max_examples:
                break
            image_embeddings, text_embeddings = embed_fn(batch)
            pos = torch.sum(l2_normalize(image_embeddings)
                            * l2_normalize(text_embeddings), dim=1)
            for idx in torch.nonzero(pos < self.similarity_threshold)[
                    :, 0].tolist():
                if len(hard_examples) < max_examples:
                    hard_examples.append(batch_idx * pos.shape[0] + idx)
        self.mined_examples = hard_examples
        return hard_examples

    def compute_loss(self, image_embeddings, text_embeddings,
                     similarity=None, temperature=None):
        self.steps += 1
        if similarity is None:
            similarity = torch.matmul(l2_normalize(image_embeddings),
                                      l2_normalize(text_embeddings).T)
        weights = self.get_curriculum_weight(similarity)
        return self.criterion(image_embeddings, text_embeddings, weights,
                              temperature=temperature)


def curriculum_weights_traced(similarity, kind):
    """The curriculum weights of the diagonal for the rule ``kind`` (an int
    or an integer tensor, clipped to [0, 2]), chosen on the device. The
    weights keep the similarity's gradient, as in JAX."""
    pos = torch.diagonal(similarity)
    kind = torch.clamp(torch.as_tensor(kind, device=pos.device), 0, 2)
    return torch.where(kind == 0, torch.sigmoid(pos * 10),
                       torch.where(kind == 1, torch.ones_like(pos),
                                   1 - torch.sigmoid(pos * 10 - 5)))
