"""The plain reference against the port's CPU path at tiny widths, and the
check's control and planted faults: each must make ``correct`` false."""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from perfbench import calibrate, check, harness
from perfbench.check import (
    drive_program,
    gaps,
    judge,
    reference_readings,
)
from perfbench.weights import draw_batch

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (3, 2 ** 31 + 11)
BUILD = harness.build  # the harness's own, before a test replaces it


def tiny(cell_name="bert-base.s512", **widths):
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "bert-base.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_hidden_layers=2)
    cfg.update(widths)
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / f"{cell_name}.json").read_text())
    return harness.Cell("tiny", 1, cfg, {"seq": 16, "batch": 4}, limits,
                        [])


def float32_build(cell, seed, device):
    """The program's step as the harness builds it for a float32 config
    (no AMP), where it and the reference agree to rounding order."""
    cell = harness.Cell(cell.name, cell.chips,
                        {**cell.cfg, "compute_dtype": "float32"},
                        cell.traffic, cell.limits, cell.metrics)
    step, state = BUILD(cell, seed, device)
    assert state[0].dtype is None  # no AMP
    return step, state


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_is_the_port_in_float32(seed):
    cell = tiny()
    step, state = float32_build(cell, seed, "cpu")
    _, prog = drive_program(step, state, cell.cfg, seed, "cpu")
    ref = reference_readings(cell.cfg, cell.traffic, seed, "cpu")
    g = gaps(prog, ref)
    assert g["loss_gap"] < 1e-6
    assert g["grad_gap"] < 1e-4
    assert g["change_gap"] < 1e-3
    assert g["thr_mismatch"] == 0 and g["pattern_mismatch"] == 0
    assert len(prog.thresholds) == 6 and len(prog.patterns) == 6


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def test_reference_rounds_where_the_amp_port_rounds():
    """Rounded to bfloat16 where the reference says the program rounds,
    the reference's first loss is the AMP program's."""
    cell, seed = tiny(), 5
    step, state = harness.build(cell, seed, torch.device("cpu"))
    _, prog = drive_program(step, state, cell.cfg, seed, "cpu")
    ref = reference_readings(cell.cfg, cell.traffic, seed, "cpu",
                             low=_Bf16.apply)
    assert abs(prog.losses[0] - ref.losses[0]) < 1e-5 * ref.losses[0]


def _broken(kind: str):
    """A build whose step is broken in one way, on the float32 program's
    model and optimizer and the cell's batch."""
    def build(cell, seed, device):
        _, state = float32_build(cell, seed, device)
        tokens, labels = draw_batch(cell.cfg, cell.traffic, seed, device)
        if kind == "label_altered":
            labels[0] = (labels[0] + 1) % cell.cfg["num_classes"]
        rows = tokens.shape[0] // 2 if kind == "half_batch" else None

        def step(state):
            model, opt = state
            for p in model.parameters():
                p.grad = None
            loss = F.cross_entropy(model(tokens[:rows]), labels[:rows])
            loss.backward()
            if kind != "frozen":
                opt.step()
            return state, loss.detach()

        return step, state
    return build


def _execute(cell, seed):
    start = time.monotonic()
    return harness.execute(cell, seed, 0.2, False, torch.device("cpu"),
                           lambda: time.monotonic() - start)


def test_the_sound_float32_step_is_correct(monkeypatch):
    monkeypatch.setattr(harness, "build", float32_build)
    assert _execute(tiny(), SEEDS[1])["correct"] is True


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "label_altered"])
def test_a_planted_fault_makes_correct_false(monkeypatch, fault):
    monkeypatch.setattr(harness, "build", _broken(fault))
    result = _execute(tiny(), SEEDS[1])
    assert result["correct"] is False
    assert any(r["value"] > r["limit"] for r in result["check"].values())


@contextlib.contextmanager
def _unobserved(model, readings):
    yield readings


@pytest.mark.parametrize("seen", ["none", "one kind less", "other shape"])
def test_an_unobserved_quantizer_makes_correct_false(monkeypatch, seen):
    """Thresholds and patterns that the step did not show, in whole or in
    part, fail the exact comparison instead of reading 0 mismatches."""
    if seen == "none":
        monkeypatch.setattr(check, "observe_quantizer", _unobserved)
        monkeypatch.setattr(harness, "build", float32_build)
        result = _execute(tiny(), SEEDS[1])
        assert result["correct"] is False
        assert math.isinf(result["check"]["thr_mismatch"]["value"])
        assert math.isinf(result["check"]["pattern_mismatch"]["value"])
        return
    cell, seed = tiny(), SEEDS[0]
    step, state = float32_build(cell, seed, "cpu")
    _, prog = drive_program(step, state, cell.cfg, seed, "cpu")
    ref = reference_readings(cell.cfg, cell.traffic, seed, "cpu")
    kind = sorted(prog.patterns)[0]
    if seen == "one kind less":
        del prog.thresholds[kind], prog.patterns[kind]
    else:
        prog.thresholds[kind] = prog.thresholds[kind][:1]
        prog.patterns[kind] = prog.patterns[kind][:1]
    g = gaps(prog, ref)
    assert math.isinf(g["thr_mismatch"]) and math.isinf(g["pattern_mismatch"])
    assert not judge(g, cell.limits)[0]


@pytest.mark.parametrize("key, value", [
    ("vocab_size", 30522), ("num_classes", 2), ("learning_rate", 1e-3),
    ("weight_decay", 0.01), ("compute_dtype", "float16")])
def test_a_config_the_program_does_not_run_is_refused(key, value):
    cell = tiny()
    cell.cfg[key] = value
    with pytest.raises(ValueError, match="does not run"):
        harness.build(cell, 1, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_float8_control_is_not_correct(seed):
    cell = tiny()
    control = calibrate.readings(cell, seed, torch.device("cpu"),
                                 names=("control",))["control"]
    correct, _ = judge(control, cell.limits)
    assert not correct


@pytest.mark.cuda
def test_on_the_card_the_port_passes_and_the_control_fails():
    """At bert-base's widths, 2 layers, 8 rows of 128: the AMP program's
    readings within the cell's limits, the float8 control's not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    cell = tiny(hidden_size=768, intermediate_size=3072,
                num_attention_heads=12)
    cell.traffic.update(seq=128, batch=8)
    for seed in SEEDS:
        step, state = harness.build(cell, seed, device)
        _, prog = drive_program(step, state, cell.cfg, seed, device)
        del step, state
        ref = reference_readings(cell.cfg, cell.traffic, seed, device)
        assert judge(gaps(prog, ref), cell.limits)[0]
        control = calibrate.readings(cell, seed, device,
                                     names=("control",))["control"]
        assert not judge(control, cell.limits)[0]
