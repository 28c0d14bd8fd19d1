"""The benchmark's harness on the CPU: BENCHMARK.json against the contract
the files keep, the result line, a run without a card, and the modules a
run loads."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(traced: bool, limits=None) -> harness.Cell:
    cfg = json.loads((BENCH / "configs" / "bert-base.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_hidden_layers=2)
    kind = "per_layer" if traced else "end_to_end"
    return harness.Cell(
        "tiny", 1, cfg, {"seq": 16, "batch": 4},
        limits or json.loads((BENCH / "limits"
                              / "bert-base.s512.json").read_text()),
        [(m["name"], m["unit"]) for m in bench()[kind]])


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    cells = b["workloads"]
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       and k != "vocab_size" for k in c["reduced"])
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert [m["name"] for m in b["end_to_end"]] == [
        "tokens_per_s", "peak_mem_gib", "setup_s"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] == "tokens_per_s"
        assert set(m["workloads"]) <= {w["name"] for w in cells}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(b)) < 64 * 1024


def test_harness_has_no_branch_on_a_cell_or_metric_name():
    b = bench()
    names = {w["name"] for w in b["workloads"]} | {
        c["name"] for c in b["configs"]} | {
        m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for module in ("run.py", "harness.py", "check.py", "trace.py"):
        source = (BENCH / module).read_text()
        for name in names:
            assert f'"{name}"' not in source, (module, name)


def test_result_line_keys_untraced_and_traced():
    for traced in (False, True):
        start = time.monotonic()
        result = harness.execute(tiny_cell(traced), 2 ** 31 + 7, 0.5,
                                 traced, torch.device("cpu"),
                                 lambda: time.monotonic() - start)
        assert list(result)[:5] == ["correct", "attempted", "failed",
                                    "metrics", "device"]
        assert list(result)[-1] == "check"
        assert set(result["check"]) == {"loss_gap", "grad_gap",
                                         "change_gap", "thr_mismatch",
                                         "pattern_mismatch"}
        for row in result["check"].values():
            assert set(row) == {"value", "limit"}
        assert result["attempted"] > 0 and result["failed"] == 0
        device = result["device"]
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(device)
        if traced:
            assert {"busy_s", "window_s"} <= set(device)
            assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(result["metrics"]) == {"tokens_per_s",
                                              "peak_mem_gib", "setup_s"}
        json.dumps(result)


def _run(cwd, hide_cards: bool):
    env = {**os.environ, "PYTHONPATH": ""}
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "bert-base.s512", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def _json_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return isinstance(json.loads(lines[-1]), dict)
    except json.JSONDecodeError:
        return False


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run(ROOT, hide_cards=True)
    assert out.returncode != 0
    assert not _json_line(out.stdout)
    assert "CUDA" in out.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # No card here: the run stops there; on the card, at the missing program.
    out = _run(tmp_path, hide_cards=False)
    assert out.returncode != 0
    assert not _json_line(out.stdout)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, name)
            assert top != "benchmarks", (path, name)


def test_a_run_loads_no_jax_module():
    code = ("import sys, perfbench.run, perfbench.calibrate, "
            "perfbench.trace, atq_tpu_torch.train.scale\n"
            "from perfbench import harness\n"
            "import json\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "run = harness.Run({}, {})\n"
            "[run.metric(m['name']) for m in b['end_to_end'] + "
            "b['per_layer']]\n"
            "print(harness.forbidden_modules())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    found, loaded = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "atq_tpu_torch" in loaded and "'atq_tpu'" not in loaded


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import atq_tpu_torch  # noqa: F401 (begins with the JAX package's name)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "atq_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["atq_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_program():
    for module in ("reference.py", "weights.py", "flops.py"):
        for name in _imports(BENCH / module):
            assert not name.startswith("atq_tpu"), (module, name)
    code = ("import sys, perfbench.reference, perfbench.weights\n"
            "print(sorted(m for m in sys.modules if m.startswith('atq')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_per_layer_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = tiny_cell(True)
    cell.cfg.update(hidden_size=768, intermediate_size=3072,
                    num_attention_heads=12)
    cell.traffic.update(seq=128, batch=8)
    start = time.monotonic()
    result = harness.execute(cell, 5, 1.0, True, torch.device("cuda", 0),
                             lambda: time.monotonic() - start)
    assert set(result["metrics"]) == {m["name"]
                                      for m in bench()["per_layer"]}
    assert 0 < result["metrics"]["attn.roofline"]["value"] <= 100
    assert 0 < result["metrics"]["step.mfu"]["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
