"""Learning-rate schedules (port of atq_tpu/train/schedules_lr.py).

Plain functions of the update count: update ``i`` (from 0) uses
``schedule(i)``, as optax's schedule count does. Computed in float32 like
the JAX versions, returned as a Python float.
"""

from __future__ import annotations

import math

import numpy as np


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, min_factor: float = 0.1):
    """Linear warmup over ``warmup_steps``, then cosine decay with a floor
    of ``min_factor``."""
    def schedule(step: int) -> float:
        step = np.float32(step)
        warmup = step / np.float32(max(1.0, warmup_steps))
        progress = (step - np.float32(warmup_steps)) / np.float32(
            max(1.0, total_steps - warmup_steps))
        cosine = max(np.float32(min_factor), np.float32(0.5) * (
            np.float32(1.0) + np.cos(np.float32(math.pi) * progress)))
        factor = warmup if step < warmup_steps else cosine
        return float(np.float32(base_lr) * factor)

    return schedule


def step_lr_schedule(base_lr: float, steps_per_epoch: int, step_size: int,
                     gamma: float = 0.5):
    """StepLR: ``base_lr · gamma^(epoch // step_size)``."""
    step_size = max(1, step_size)

    def schedule(step: int) -> float:
        epoch = int(step) // max(1, steps_per_epoch)
        return float(np.float32(base_lr)
                     * np.float32(gamma ** (epoch // step_size)))

    return schedule
