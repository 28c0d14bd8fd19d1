"""Op-level step profiling: capture a ``torch.profiler`` trace and summarize
it (port of atq_tpu/utils/profile_step.py).

The trainers write a trace of their first epoch behind ``--profile-dir``
(classifier) and ``--profile_dir`` (retrieval); this module reads such a
Chrome trace back so "where does the step time go" is answerable without
TensorBoard: it aggregates the trace's complete events by name and prints
the top-k by total time. :func:`step_breakdown` gives the per-step host
and device time of the trainers' training steps (their ``train_steps``
span), leaving out the validation the window also holds.

Track selection follows PyTorch's trace, not XLA's lanes: "device only"
keeps the events whose ``cat`` is ``kernel``, ``gpu_memset`` or
``gpu_memcpy`` (what ran on the card). When there are none, as in a trace
taken on the CPU, it uses every complete event, as the JAX module falls
back to all tracks. The profiler's own window event (``cat`` ``Trace``) is
never an op and is left out.

Typical use::

    from atq_tpu_torch.utils.profile_step import profile_fn, print_summary
    summary = profile_fn(lambda: step(batch), iters=10)
    print_summary(summary)

or post-hoc on a ``--profile_dir`` capture::

    python -m atq_tpu_torch.utils.profile_step outputs/run1/trace
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
_WINDOW_CATEGORY = "Trace"
# The trainers' span around one epoch's training steps (record_function),
# which step_breakdown reads the per-step figures from.
TRAIN_SPAN = "train_steps"


@dataclass
class OpStat:
    name: str
    total_us: float
    count: int
    pct: float


def latest_trace_file(trace_dir: str) -> str:
    """The newest ``*.trace.json`` or ``*.trace.json.gz`` under
    ``trace_dir`` (searched recursively)."""
    pats = [
        os.path.join(trace_dir, "**", "*.trace.json.gz"),
        os.path.join(trace_dir, "**", "*.trace.json"),
    ]
    hits: List[str] = []
    for p in pats:
        hits.extend(glob.glob(p, recursive=True))
    if not hits:
        raise FileNotFoundError(
            f"no *.trace.json(.gz) under {trace_dir!r}: was the trace "
            f"captured with torch.profiler (--profile_dir)?")
    return max(hits, key=os.path.getmtime)


def load_events(path: str) -> List[dict]:
    """The ``traceEvents`` of a Chrome trace file (gzipped or not)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def complete_events(events: List[dict], device_only: bool) -> List[dict]:
    """The complete (``ph`` X) events that :func:`summarize_trace` counts:
    the device's when ``device_only`` and the trace has any, else all but
    the profiler's window."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e
                and e.get("cat") != _WINDOW_CATEGORY]
    if device_only:
        hit = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
        if hit:
            return hit
    return complete


def summarize_trace(trace_dir: str, top: int = 25,
                    device_only: bool = True) -> List[OpStat]:
    """Aggregate complete events by name, descending total duration.

    Args:
        trace_dir: the directory the trace was written under.
        top: max rows returned.
        device_only: keep only the card's kernels, memsets and copies
            (fall back to all events when there are none, e.g. a trace
            taken on the CPU).
    """
    events = complete_events(load_events(latest_trace_file(trace_dir)),
                             device_only)
    agg: Dict[str, List[float]] = {}
    for e in events:
        cur = agg.setdefault(e.get("name", "?"), [0.0, 0])
        cur[0] += float(e["dur"])
        cur[1] += 1
    total = sum(v[0] for v in agg.values()) or 1.0
    stats = [OpStat(name=k, total_us=v[0], count=int(v[1]),
                    pct=100.0 * v[0] / total)
             for k, v in agg.items()]
    stats.sort(key=lambda s: -s.total_us)
    return stats[:top]


def self_times(events: List[dict]) -> List[tuple]:
    """``(name, self us)`` of each host event: its duration less its
    direct children's on the same thread (the profiler's self CPU time)."""
    threads: Dict[tuple, List[dict]] = {}
    for e in events:
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []  # [end, event, children's us]
        for e in evs + [None]:
            while stack and (e is None or stack[-1][0] <= e["ts"]):
                _, ev, children = stack.pop()
                out.append((ev.get("name", "?"), ev["dur"] - children))
            if e is not None:
                if stack:
                    stack[-1][2] += e["dur"]
                stack.append([e["ts"] + e["dur"], e, 0.0])
    return out


def span_events(events: List[dict], span: Optional[str] = None):
    """``(host events, device events, wall us)`` of a trace's complete
    events. With ``span`` (a ``record_function`` name, e.g.
    :data:`TRAIN_SPAN`) and the trace holding it: the host events that
    start inside one of its occurrences, the device events they launched
    (matched by the launch's ``correlation``; by start time where an event
    has none), and the spans' summed duration; the span events themselves
    are not among the host events. Otherwise every host and
    device event and the traced window."""
    complete = complete_events(events, device_only=False)
    host = [e for e in complete if e.get("cat") in HOST_CATEGORIES]
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in host
               if span is not None and e.get("name") == span
               and e.get("cat") == "user_annotation"]
    if not windows:
        marks = [e["dur"] for e in events if e.get("ph") == "X"
                 and e.get("cat") == _WINDOW_CATEGORY]
        wall = (max(marks) if marks else
                max((e["ts"] + e["dur"] for e in complete), default=0.0)
                - min((e["ts"] for e in complete), default=0.0))
        return host, device, wall

    def inside(e):
        return any(a <= e["ts"] < b for a, b in windows)

    # The spans are windows, not ops: their events are left out.
    host = [e for e in host if inside(e) and not (
        e.get("name") == span and e.get("cat") == "user_annotation")]
    launched = {e["args"]["correlation"] for e in host
                if "correlation" in e.get("args", {})}
    device = [e for e in device
              if (e["args"]["correlation"] in launched
                  if "correlation" in e.get("args", {}) else inside(e))]
    return host, device, sum(b - a for a, b in windows)


def step_breakdown(events: List[dict], steps: int,
                   span: Optional[str] = None, top: int = 8) -> dict:
    """Per step of a trace's ``span`` (:func:`span_events`; the whole
    trace without it): host time (the host events' self time), device
    time, the host ops with the most self time and the device kernels
    with the most time (ms), and the busy share, device time over the
    wall time."""
    host, device, wall = span_events(events, span)

    def per_step(pairs):
        totals: Dict[str, float] = {}
        for name, us in pairs:
            totals[name] = totals.get(name, 0.0) + us
        rows = sorted(((t, n) for n, t in totals.items()), reverse=True)
        return [[n, t / 1e3 / steps] for t, n in rows[:top] if t > 0]

    host_self = self_times(host)
    device_us = sum(e["dur"] for e in device)
    return {"steps": steps, "share": device_us / max(wall, 1e-9),
            "wall_ms": wall / 1e3,
            "host_ms_per_step": sum(us for _, us in host_self) / 1e3 / steps,
            "device_ms_per_step": device_us / 1e3 / steps,
            "top_host_ops_ms_per_step": per_step(host_self),
            "top_device_kernels_ms_per_step": per_step(
                (e.get("name", "?"), e["dur"]) for e in device)}


def start_trace(trace_dir: str, device):
    """A started ``torch.profiler`` capture (the card too on a CUDA
    ``device``) whose :func:`stop_trace` writes a Chrome trace
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``trace_dir``: the trainers'
    ``--profile_dir`` window, as ``jax.profiler.start_trace`` opens it."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
        else [])
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))
    prof.start()
    return prof


def stop_trace(prof, device) -> None:
    """End a :func:`start_trace` capture once the card has finished the
    work enqueued in it, and write its trace."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


def profile_fn(fn: Callable[[], object], iters: int = 10,
               trace_dir: Optional[str] = None, top: int = 25,
               device="cuda") -> List[OpStat]:
    """Run ``fn`` ``iters`` times under ``torch.profiler``, write the Chrome
    trace under ``trace_dir`` and return its summary.

    One untraced warm-up call comes first (kernel builds and caches stay
    out of the capture); on a CUDA ``device`` the profiler also records the
    card and the capture ends with a synchronize.
    """
    import tempfile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="atq_profile_")
    fn()  # warm-up outside the capture
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof = start_trace(trace_dir, device)
    for _ in range(iters):
        fn()
    stop_trace(prof, device)
    return summarize_trace(trace_dir, top=top)


def print_summary(stats: List[OpStat], file=None) -> None:
    width = max((len(s.name) for s in stats), default=10)
    width = min(width, 70)
    print(f"{'op':{width}s} {'total ms':>10s} {'count':>7s} {'%':>6s}",
          file=file)
    for s in stats:
        print(f"{s.name[:width]:{width}s} {s.total_us / 1e3:10.3f} "
              f"{s.count:7d} {s.pct:6.2f}", file=file)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m atq_tpu_torch.utils.profile_step",
        description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dir", help="--profile_dir of a previous run")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--all-tracks", action="store_true",
                   help="include host-side events, not just device ops")
    args = p.parse_args(argv)
    print_summary(summarize_trace(args.trace_dir, top=args.top,
                                  device_only=not args.all_tracks))


if __name__ == "__main__":
    main()
