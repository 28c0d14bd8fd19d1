"""One run of a cell, driven by data.

A cell is an entry of BENCHMARK.json's ``workloads``. Its configuration is
the file that ``configs`` names for it, its traffic
``perfbench/workloads/<traffic>.json``, the limits of its check
``perfbench/limits/<cell>.json``, and each metric that BENCHMARK.json lists
for it (``end_to_end`` untraced, ``per_layer`` traced; all of them, or the
cells under the metric's ``workloads``) is read by
``perfbench/metrics/<metric>.py``'s ``read(run)``. A reader that finds
nothing to read returns None and the metric is left out of the line.

The run (:func:`execute`):

1. builds the program's step (atq_tpu_torch.train.scale ``build_step``:
   remat, scanned stack, fused attention, hoisted quantization, AMP where
   the config's ``compute_dtype`` is bfloat16) at the config's widths and
   the traffic's batch and sequence, and overwrites its parameters and
   buffers with the seeded tensors (perfbench/weights.py). A config that
   states a vocabulary, class count, learning rate or weight decay other
   than the program's is refused;
2. drives the first three steps through the same ``step``, taking the
   check's readings (perfbench/check.py), then ``WARMUP_STEPS`` more,
   and freezes the set-up's objects out of Python's cyclic collector
   until the window has closed;
3. untraced: resets the peak-memory statistics, calls ``step`` back to
   back for ``seconds`` with nothing synchronized, and ends with
   ``torch.cuda.synchronize()``; traced: runs ``TRACE_STEPS`` steps
   under the profiler (perfbench/trace.py);
4. frees the program, runs the float32 reference's three steps and
   judges the readings against the cell's limits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.check import (
    drive_program,
    gaps,
    judge,
    load_inputs,
    reference_readings,
    worst_readings,
)
from perfbench.weights import make_tensors, program_seed

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "atq_tpu"})
WARMUP_STEPS = 2
TRACE_STEPS = 3
AMP = {"bfloat16": True, "float32": False}  # compute_dtype: use_amp


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[Tuple[str, str]]  # (name, unit)


def load_cell(name: str, traced: bool, bench_path: Path = ROOT
              / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files, and the metrics
    a run of it reports (``per_layer`` when ``traced``)."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}; "
                       f"known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    kind = "per_layer" if traced else "end_to_end"
    metrics = [(m["name"], m["unit"]) for m in bench[kind]
               if name in m.get("workloads", [name])]
    return Cell(name, entry["chips"],
                load_json(ROOT / configs[entry["config"]]["file"]),
                load_json(HERE / "workloads" / f"{entry['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"), metrics)


@dataclass
class Window:
    steps: int
    seconds: float
    peak_bytes: int


@dataclass
class Run:
    """What the metric readers read."""
    cfg: dict
    traffic: dict
    setup_s: Optional[float] = None
    window: Optional[Window] = None
    trace: object = None
    _modules: dict = field(default_factory=dict)

    def metric(self, name: str):
        """The reader module ``perfbench/metrics/<name>.py``."""
        if name not in self._modules:
            path = HERE / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                "perfbench.metrics." + name.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[name] = module
        return self._modules[name]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def build(cell: Cell, seed: int, device):
    """The program's ``(step, state)`` at the cell's sizes, holding the
    seeded tensors."""
    from atq_tpu_torch.train import scale

    cfg, traffic = cell.cfg, cell.traffic
    fixed = {"vocab_size": scale.VOCAB, "num_classes": scale.N_CLASSES,
             "learning_rate": scale.LEARNING_RATE,
             "weight_decay": scale.WEIGHT_DECAY}
    differ = {k: (cfg[k], v) for k, v in fixed.items() if cfg[k] != v}
    if differ or cfg["compute_dtype"] not in AMP:
        raise ValueError(f"the config states what build_step does not run "
                         f"(config, program): {differ}; compute_dtype "
                         f"{cfg['compute_dtype']!r} of {sorted(AMP)}")
    step, _, state, _ = scale.build_step(
        cfg["hidden_size"], cfg["intermediate_size"],
        cfg["num_attention_heads"], cfg["num_hidden_layers"],
        traffic["seq"], traffic["batch"], remat=True, scan=True,
        use_amp=AMP[cfg["compute_dtype"]], attn_impl="fused",
        hoist_quant=True, device=device, seed=program_seed(seed))
    load_inputs(state[0], make_tensors(cfg, seed, device))
    return step, state


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            clock: Callable[[], float]) -> dict:
    """One run; the result line's object (``check`` last). ``clock`` gives
    the seconds since the process started."""
    marks = [clock()]
    step, state = build(cell, seed, device)
    marks.append(clock())
    state, readings = drive_program(step, state, cell.cfg, seed, device)
    marks.append(clock())
    for _ in range(WARMUP_STEPS):
        state, _ = step(state)
    _sync(device)
    # The set-up's ~270,000 objects (imports, model, the check's readings)
    # stay; a full collection that walks them stalls the host ~150 ms, in
    # some windows and not others. Frozen, the window's collections walk
    # only what the steps make.
    gc.collect()
    gc.freeze()
    marks.append(clock())
    print("setup s: to the build {:.2f}, build and inputs {:.2f}, checked "
          "steps {:.2f}, warm-up {:.2f}".format(
              marks[0], *(b - a for a, b in zip(marks, marks[1:]))),
          file=sys.stderr)
    run = Run(cell.cfg, cell.traffic)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        from perfbench.trace import capture

        state, losses, run.trace = capture(step, state, TRACE_STEPS,
                                           device)
    else:
        run.setup_s = clock()
        losses = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            state, loss = step(state)
            losses.append(loss)
        _sync(device)
        run.window = Window(len(losses), time.perf_counter() - start, 0)
    gc.unfreeze()
    peak = _peak(device)
    if run.window is not None:
        run.window.peak_bytes = peak
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell.cfg, cell.traffic, seed, device)
    correct, table = judge(gaps(readings, ref), cell.limits)
    metrics = {}
    for name, unit in cell.metrics:
        value = run.metric(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct and failed == 0,
              "attempted": len(losses), "failed": failed,
              "metrics": metrics, "device": info}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_us / 1e6
        info["window_s"] = run.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["readings"] = worst_readings(readings, ref)
    result["check"] = table
    return result


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the port's run must not
    load (JAX and the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
