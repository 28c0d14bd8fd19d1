"""Steady-state step timing (port of the part of atq_tpu/utils/timing.py
that the production-shape step uses).

On the card the window is timed with CUDA events around ``iters`` chained
steps after ``warmup`` untimed ones, so the number is device time per step
with the host's enqueue overlapped, not a host clock around unsynchronised
launches. A CPU run (the tests) uses the host clock; its numbers are CPU
times and are reported under the device they ran on.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def steady_state_sec_per_step(step_fn: Callable, state, args: Sequence = (),
                              warmup: int = 2, iters: int = 8,
                              device=None):
    """Seconds per chained ``step_fn(state, *args) -> (state, out)`` call
    and the final state: ``(sec_per_step, state)``."""
    device = torch.device(device) if device is not None else None
    on_cuda = device is not None and device.type == "cuda"
    for _ in range(warmup):
        state, _ = step_fn(state, *args)
    if on_cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state, _ = step_fn(state, *args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters, state
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = step_fn(state, *args)
    return (time.perf_counter() - t0) / iters, state
