"""A ``torch.profiler`` trace of a few steady steps, read back.

:func:`capture` runs ``steps`` calls of the window's ``step`` under the
profiler (CPU and CUDA activities) inside one ``record_function`` span,
ends with a synchronize, writes the Chrome trace to a temporary file and
reads it back into a :class:`Trace`. The readers of the trace's events
are those of atq_tpu_torch/utils/profile_step.py (``complete_events``, the
device categories, the profiler's window event left out), copied here so
that the yardstick does not move with the program.

The traced window runs from the span's start to the later of its end and
the last device event's end; ``busy_us`` is the union of the device
events (kernels, memsets, copies) inside it.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
WINDOW_CATEGORY = "Trace"
SPAN = "perfbench.window"
TOP = 10
NAME_CHARS = 160


def complete_events(events: List[dict]) -> List[dict]:
    """The complete (``ph`` X) events, less the profiler's window."""
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") != WINDOW_CATEGORY]


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted, as disjoint ones."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclass
class Trace:
    """The device's events (``name``, start, duration, in µs) of a traced
    window of ``steps`` steps, and the host's, for the idle gaps."""
    steps: int
    kernels: List[Tuple[str, float, float]]
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start_us: float
    end_us: float

    @classmethod
    def from_events(cls, events: List[dict], steps: int) -> "Trace":
        complete = complete_events(events)
        spans = [e for e in complete if e.get("name") == SPAN]
        if not spans:
            raise ValueError(f"the trace has no '{SPAN}' span")
        span = spans[0]
        start, end = span["ts"], span["ts"] + span["dur"]

        def rows(cats):
            return [(e.get("name", "?"), float(e["ts"]), float(e["dur"]),
                     e.get("cat")) for e in complete
                    if e.get("cat") in cats and e["ts"] >= start]

        device = rows(DEVICE_CATEGORIES)
        end = max([end] + [ts + dur for _, ts, dur, _ in device])
        kernels = [(n, ts, dur) for n, ts, dur, cat in device
                   if cat == "kernel"]
        device = [(n, ts, dur) for n, ts, dur, _ in device]
        host = [(n, ts, dur) for n, ts, dur, _ in rows(HOST_CATEGORIES)
                if n != SPAN]
        return cls(steps, kernels, device, host, float(start), float(end))

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return merge([(max(ts, self.start_us), min(ts + dur, self.end_us))
                      for _, ts, dur in self.device])

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_ms_per_step(self, keep: Callable[[str], bool]) -> float:
        """Device ms a step in the kernels whose name ``keep`` accepts."""
        return sum(dur for name, _, dur in self.kernels
                   if keep(name)) / 1e3 / self.steps

    def top_device_ops(self) -> List[list]:
        """``[name, seconds]`` of the kernels that took most time."""
        totals: Dict[str, float] = {}
        for name, _, dur in self.device:
            key = name[:NAME_CHARS]
            totals[key] = totals.get(key, 0.0) + dur
        return [[n, us / 1e6] for n, us in
                sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """``[host activity, seconds]``: the window's idle time (no device
        event running) summed by the innermost host event under each
        gap's midpoint, largest first."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for ab in busy for x in ab] \
            + [self.end_us]
        hosts = sorted(self.host, key=lambda h: h[1])
        active: List[Tuple[float, float, str]] = []  # (end, dur, name)
        totals: Dict[str, float] = {}
        i = 0
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(hosts) and hosts[i][1] <= mid:
                name, ts, dur = hosts[i]
                heapq.heappush(active, (ts + dur, dur, name))
                i += 1
            while active and active[0][0] <= mid:
                heapq.heappop(active)
            name = (min(active, key=lambda h: h[1])[2][:NAME_CHARS]
                    if active else "host outside any traced op")
            totals[name] = totals.get(name, 0.0) + (b - a)
        return [[n, us / 1e6] for n, us in
                sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def capture(step: Callable, state, steps: int, device):
    """``(state, losses, Trace)`` of ``steps`` calls of ``step`` under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    losses = []
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        with record_function(SPAN):
            for _ in range(steps):
                state, loss = step(state)
                losses.append(loss)
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return state, losses, Trace.from_events(events, steps)
