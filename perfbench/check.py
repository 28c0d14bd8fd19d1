"""Whether the timed path computes the step it claims to.

The program's first three steps run through the window's own ``step``
on the cell's batch (the harness's set-up), and these readings are taken
from them:

- each step's loss, as ``step`` returns it;
- after step 1, each leaf's gradient norm as the optimizer gets it
  (``p.grad``), a stacked (L, ...) leaf read layer by layer;
- during step 1, the hoisted quantizer's thresholds and ternary patterns,
  seen through atq_tpu_torch.core.quantize's batched functions as the
  step calls them (a wrapper that returns their results unchanged);
- after step 3, each leaf's change from the seeded start.

The reference (perfbench/reference.py) follows the same three steps from
the same tensors and batch, once the window has closed and the program is
freed. The numbers compared (:func:`gaps`):

- ``loss_gap``: the first step's |loss - loss_ref| / |loss_ref|;
- ``grad_gap``: the median leaf's |norm - norm_ref| over the larger of
  its reference norm and the median leaf's (:func:`leaf_gaps`);
- ``change_gap``: the same of the change after three steps, over the
  leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's (the others, such as a key's bias under softmax, move by
  round-off alone);
- ``thr_mismatch`` and ``pattern_mismatch``: thresholds (a layer and
  kind each) and ternary entries that differ; exact, limit 0. A kind
  that the program's step did not show, or showed at another shape,
  reads infinite: the comparison fails closed.

The first step's loss and the median leaf stand in for every step's loss
and the worst leaf: AdamW's first update is
lr times the sign of each gradient entry, so the later steps' losses and
the changes carry every near-zero entry's sign, whatever the precision;
and a layer's alpha gradient is a sum over its whole weight that cancels
almost to nothing, so any one rounding moves it by its own size (PERF.md
gives the readings). :func:`worst_readings` keeps those numbers for the
record.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from perfbench.reference import (
    KINDS,
    STACK,
    Reference,
    identity,
    tensor_specs,
)
from perfbench.weights import draw_batch, make_tensors

CHECK_STEPS = 3
MOVED = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "thr_mismatch",
           "pattern_mismatch")


@dataclass
class Readings:
    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)
    thresholds: Dict[str, torch.Tensor] = field(default_factory=dict)
    patterns: Dict[str, torch.Tensor] = field(default_factory=dict)


def leaf_norms(pairs: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """Float64 norms by leaf; a stacked leaf (``layers.scan.layer.*``)
    gives one per layer, ``name[i]``."""
    out = {}
    for name, t in pairs:
        t = t.detach().double()
        if name.startswith(STACK):
            norms = t.reshape(t.shape[0], -1).norm(dim=1).tolist()
            out.update({f"{name}[{i}]": v for i, v in enumerate(norms)})
        else:
            out[name] = t.norm().item()
    return out


@torch.no_grad()
def load_inputs(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """Overwrite the program's parameters and buffers with the seeded
    tensors. Its tensors must be those of ``tensor_specs``, name for name
    and shape for shape."""
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    want = {n: (tuple(t.shape), t.dtype) for n, t in tensors.items()}
    have = {n: (tuple(t.shape), t.dtype) for n, t in own.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise RuntimeError(f"the program's tensors are not the config's: "
                           f"{diff[:8]}")
    for name, t in tensors.items():
        own[name].copy_(t)


@contextlib.contextmanager
def observe_quantizer(model: torch.nn.Module, readings: Readings):
    """Record the batched quantizer's thresholds and patterns, by kind,
    while the block runs; the functions' results are returned unchanged."""
    from atq_tpu_torch.core import quantize

    kinds = {p.data_ptr(): name[len(STACK):-len(".weight")]
             for name, p in model.named_parameters()
             if name.startswith(STACK) and name.endswith(".weight")
             and name[len(STACK):-len(".weight")] in KINDS}
    thr_fn = quantize.ternary_threshold_batched
    pat_fn = quantize.adaptive_ternary_quantization_batched

    def thresholds(weights, *args, **kwargs):
        out = thr_fn(weights, *args, **kwargs)
        kind = kinds.get(weights.data_ptr())
        if kind is not None:
            readings.thresholds[kind] = out.detach().cpu()
        return out

    def patterns(weights, *args, **kwargs):
        w_t, alpha = pat_fn(weights, *args, **kwargs)
        kind = kinds.get(weights.data_ptr())
        if kind is not None:
            readings.patterns[kind] = w_t.detach().to(torch.int8).cpu()
        return w_t, alpha

    quantize.ternary_threshold_batched = thresholds
    quantize.adaptive_ternary_quantization_batched = patterns
    try:
        yield readings
    finally:
        quantize.ternary_threshold_batched = thr_fn
        quantize.adaptive_ternary_quantization_batched = pat_fn


def drive_program(step: Callable, state, cfg: dict, seed: int, device):
    """The program's first ``CHECK_STEPS`` steps with their readings.
    Returns ``(state, readings)``."""
    model = state[0]
    readings = Readings()
    with observe_quantizer(model, readings):
        state, loss = step(state)
    readings.losses.append(float(loss))
    readings.grad_norms = leaf_norms(
        (n, p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters())
    for _ in range(CHECK_STEPS - 1):
        state, loss = step(state)
        readings.losses.append(float(loss))
    start = make_tensors(cfg, seed, device)
    readings.change_norms = leaf_norms(
        (n, p.detach() - start[n]) for n, p in model.named_parameters())
    return state, readings


def reference_readings(cfg: dict, traffic: dict, seed: int, device,
                       low: Callable = identity, rows: Optional[int] = None,
                       alter_label: bool = False,
                       frozen: bool = False) -> Readings:
    """The reference's readings of the same three steps. For the control
    and the planted faults (perfbench/calibrate.py): ``low`` its
    precision, ``rows`` the first rows only, ``alter_label`` the first
    row's label moved by one class, ``frozen`` a step that returns its
    state unchanged."""
    tensors = make_tensors(cfg, seed, device)
    tokens, labels = draw_batch(cfg, traffic, seed, device)
    if alter_label:
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % cfg["num_classes"]
    ref = Reference(cfg, tensors, low)
    readings = Readings()
    for i in range(CHECK_STEPS):
        if frozen and i > 0:
            readings.losses.append(readings.losses[0])
            continue
        loss, grads, quantized = ref.step(tokens, labels, rows)
        readings.losses.append(loss)
        if i == 0:
            readings.grad_norms = leaf_norms(grads.items())
            readings.thresholds = {k: q[0].cpu() for k, q in
                                   quantized.items()}
            readings.patterns = {k: q[1].to(torch.int8).cpu() for k, q in
                                 quantized.items()}
        del grads, quantized
    trained = [n for n, _, _, t in tensor_specs(cfg) if t]
    readings.change_norms = leaf_norms(
        (n, torch.zeros_like(tensors[n]) if frozen
         else ref.params[n].detach() - tensors[n]) for n in trained)
    return readings


def _finite(values: List[float]) -> List[float]:
    """The values, or one infinity if any is not a finite number."""
    return values if all(math.isfinite(v) for v in values) else [math.inf]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> Dict[str, float]:
    """Per leaf: |norm - norm_ref| over the larger of its reference norm
    and the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in keys}


def mismatches(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> float:
    """Entries that differ, over every kind; infinite where the program's
    kinds or shapes are not the reference's, as when the step no longer
    calls the functions that :func:`observe_quantizer` watches."""
    if set(prog) != set(ref) or any(prog[k].shape != t.shape
                                    for k, t in ref.items()):
        return math.inf
    return float(sum(int((prog[k] != t).sum()) for k, t in ref.items()))


def gaps(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared (module docstring)."""
    if len(prog.losses) != len(ref.losses):
        return dict.fromkeys(NUMBERS, math.inf)
    g_med = statistics.median(ref.grad_norms.values())
    moved = [k for k, v in ref.grad_norms.items() if v >= MOVED * g_med]
    grad = _finite(list(leaf_gaps(prog.grad_norms, ref.grad_norms,
                                  list(ref.grad_norms)).values()))
    change = _finite(list(leaf_gaps(prog.change_norms, ref.change_norms,
                                    moved).values()))
    thr = mismatches(prog.thresholds, ref.thresholds)
    pattern = mismatches(prog.patterns, ref.patterns)
    return {"loss_gap": _finite([abs(prog.losses[0] - ref.losses[0])
                                 / abs(ref.losses[0])])[0],
            "grad_gap": statistics.median(grad),
            "change_gap": statistics.median(change),
            "thr_mismatch": thr, "pattern_mismatch": pattern}


def worst_readings(prog: Readings, ref: Readings) -> Dict[str, object]:
    """The readings the check does not compare, for the record: the
    worst step's loss gap and the worst leaf's gradient and change gaps,
    with the leaf."""
    g_med = statistics.median(ref.grad_norms.values())
    moved = [k for k, v in ref.grad_norms.items() if v >= MOVED * g_med]
    grad = leaf_gaps(prog.grad_norms, ref.grad_norms, list(ref.grad_norms))
    change = leaf_gaps(prog.change_norms, ref.change_norms, moved)
    g_leaf, c_leaf = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap_3_steps": max(abs(p - r) / abs(r) for p, r in
                                    zip(prog.losses, ref.losses)),
            "grad_gap_worst": grad[g_leaf], "grad_worst_leaf": g_leaf,
            "change_gap_worst": change[c_leaf], "change_worst_leaf": c_leaf,
            "kinds_observed": len(prog.thresholds)}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is at or under its limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table
