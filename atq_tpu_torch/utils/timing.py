"""Step and call timing (port of atq_tpu/utils/timing.py).

- :func:`steady_state_sec_per_step`: the production-shape step's number.
  On the card the window is timed with CUDA events around ``iters``
  chained steps after ``warmup`` untimed ones, so it is device time per
  step with the host's enqueue overlapped.
- :func:`steady_state_step_stats` and :func:`sec_per_call`: the JAX
  module's slope timing. Each window chains enough calls to hold about
  0.6 s of work, ends in :func:`sync_tree` (``torch.cuda.synchronize`` of
  every card the outputs live on), and is timed on the host clock; the
  round trip of a trivial op and its synchronize, measured once a device,
  is subtracted. ``sec_per_call`` takes the best of ``windows`` windows,
  ``steady_state_step_stats`` the median with its spread.

On the CPU (the tests) nothing needs a synchronize: the numbers are host
times of the CPU's work, and ``steady_state_step_stats`` names the device
and the clock in its result.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _devices(tree):
    return sorted({t.device for t in _tensors(tree)}, key=str)


def sync_tree(tree) -> None:
    """Return once every tensor in ``tree`` is computed: a synchronize of
    each card among its leaves (a CPU tensor is computed when its op
    returns)."""
    for device in _devices(tree):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


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


_TARGET_WINDOW_SEC, _MAX_ITERS = 0.6, 512


def _window_iters(pilot_sec: float, iters: int) -> int:
    """Calls a window needs for ~0.6 s of work, from a pilot window of
    ``iters`` calls (at least ``iters``, at most 512)."""
    est = pilot_sec / iters
    return min(_MAX_ITERS, max(iters, int(_TARGET_WINDOW_SEC
                                          / max(est, 1e-7))))


def steady_state_step_stats(step_fn: Callable, state,
                            args: Sequence = (), warmup: int = 3,
                            iters: int = 20, windows: int = 5):
    """Median-of-windows timing of chained ``step_fn(state, *args) ->
    (state, out)`` calls, with its spread: at least 3 windows, each
    autoscaled to ~0.6 s of work and synchronized once, less the measured
    round trip. Returns ``(stats, final_state)``; ``stats`` has the
    median, the best window, the interquartile range, every window's
    seconds per step (sorted), the calls a window, and the device and
    clock they were taken on."""
    out = None
    for _ in range(warmup):
        state, out = step_fn(state, *args)
    if out is not None:  # warmup=0: nothing to sync yet
        sync_tree(out)
    devices = set()

    def timed(n: int) -> float:
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, out = step_fn(state, *args)
        sync_tree(out)
        devices.update(_devices(out))
        return time.perf_counter() - t0

    n = _window_iters(timed(iters), iters)
    floor = max(_roundtrip_floor(d) for d in devices) if devices else 0.0
    samples = sorted(max(timed(n) - floor, 1e-9) / n
                     for _ in range(max(windows, 3)))
    k = len(samples)
    med = (samples[k // 2] if k % 2
           else 0.5 * (samples[k // 2 - 1] + samples[k // 2]))
    q1 = samples[max(0, (k - 1) // 4)]
    q3 = samples[min(k - 1, (3 * (k - 1) + 2) // 4)]
    stats = {
        "sec_per_step_median": med,
        "sec_per_step_best": samples[0],
        "sec_per_step_iqr": q3 - q1,
        "windows_sec_per_step": samples,
        "iters_per_window": n,
        "devices": [str(d) for d in sorted(devices, key=str)],
        "clock": ("host clock, each window ended by a synchronize"
                  if any(d.type == "cuda" for d in devices)
                  else "host clock (CPU run)"),
    }
    return stats, state


_FLOORS: dict = {}


def _roundtrip_floor(device: torch.device) -> float:
    """The best of 5 round trips of a trivial op on ``device`` and its
    :func:`sync_tree` (cached per device): the constant a synchronized
    window pays once."""
    if device not in _FLOORS:
        x = torch.zeros(8, device=device)
        sync_tree(x + 1)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            sync_tree(x + 1)
            best = min(best, time.perf_counter() - t0)
        _FLOORS[device] = best
    return _FLOORS[device]


def sec_per_call(fn: Callable, *args, warmup: int = 2, iters: int = 20,
                 windows: int = 3) -> float:
    """Seconds per call of a stateless ``fn(*args)``: the best of
    ``windows`` windows of ~0.6 s each, less the round trip. The calls do
    not feed each other, but one stream runs them in order, so the last
    output's synchronize bounds the window."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync_tree(out)
    devices = set(_devices(out))

    def window(n: int) -> float:
        best = float("inf")
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args)
            sync_tree(out)
            best = min(best, time.perf_counter() - t0)
        return best

    n = _window_iters(window(iters), iters)
    best = window(n)
    floor = max(_roundtrip_floor(d) for d in devices) if devices else 0.0
    return max(best - floor, 1e-9) / n
