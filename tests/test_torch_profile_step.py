"""utils/profile_step.py and the trainers' ``--profile-dir`` /
``--profile_dir`` on the CPU.

- A hand-made trace in PyTorch's Chrome-trace format (gzipped, among an
  older one) is summarized as the JAX module's test summarizes its own
  (tests/test_profile_step.py:23): device-only keeps the ``kernel``,
  ``gpu_memset`` and ``gpu_memcpy`` events; all tracks adds the host's,
  never the profiler's window event; a trace without device events falls
  back to every complete event.
- ``profile_fn`` on the CPU captures real ops after an untraced warm-up
  call, and ``python -m atq_tpu_torch.utils.profile_step DIR`` prints the
  table.
- ``step_breakdown`` on a hand-made trace with two ``train_steps`` spans
  keeps the host events that start inside them and the kernels those
  launched (by ``correlation``; by start time where a kernel has none),
  and leaves out what ran between them, as a validation pass does.
- Each trainer's flag writes a trace under the directory that
  ``summarize_trace`` reads, and the trace holds the run's first epoch
  only (JAX's window): in a 2-epoch run, one optimizer update a step of
  that epoch (``aten::_foreach_addcmul_`` is Adam's second moment), all
  inside the epoch's one ``train_steps`` span, which leaves the
  validation out; the trainer reports the kernel launches in that window
  (none on the CPU).
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from atq_tpu_torch.train import retrieval as pretrieval
from atq_tpu_torch.train.__main__ import main as classifier_main
from atq_tpu_torch.utils import profile_step
from atq_tpu_torch.utils.profile_step import (
    TRAIN_SPAN,
    load_events,
    latest_trace_file,
    print_summary,
    profile_fn,
    span_events,
    step_breakdown,
    summarize_trace,
)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("ATQ_NO_DOWNLOAD", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


HANDMADE = [
    {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "python"}},
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": 1,
     "tid": 1, "ts": 0, "dur": 99999.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
     "ts": 0, "dur": 5000.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
     "tid": 1, "ts": 10, "dur": 20.0},
    {"ph": "X", "cat": "kernel", "name": "order_stat_cluster_kernel",
     "pid": 0, "tid": 7, "ts": 0, "dur": 300.0},
    {"ph": "X", "cat": "kernel", "name": "order_stat_cluster_kernel",
     "pid": 0, "tid": 7, "ts": 400, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
     "ts": 600, "dur": 600.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0,
     "tid": 7, "ts": 1300, "dur": 50.0},
    {"ph": "s", "cat": "ac2g", "name": "launch", "pid": 1, "tid": 1,
     "ts": 10, "id": 1},
]


def test_summarize_handmade_trace(tmp_path):
    d = tmp_path / "run" / "trace"
    d.mkdir(parents=True)
    _write_trace(d / "old.pt.trace.json", [
        {"ph": "X", "cat": "kernel", "name": "stale", "ts": 0,
         "dur": 1.0}])
    os.utime(d / "old.pt.trace.json", (1, 1))
    _write_trace(d / "host_1.123.pt.trace.json.gz", HANDMADE, gz=True)
    assert latest_trace_file(str(tmp_path)).endswith(".json.gz")

    stats = summarize_trace(str(tmp_path))
    assert [s.name for s in stats] == ["gemm", "order_stat_cluster_kernel",
                                       "Memset (Device)"]
    assert stats[0].total_us == 600.0 and stats[0].count == 1
    assert stats[1].total_us == 400.0 and stats[1].count == 2
    assert abs(sum(s.pct for s in stats) - 100.0) < 1e-9

    every = summarize_trace(str(tmp_path), top=2, device_only=False)
    assert [s.name for s in every] == ["aten::mm", "gemm"]
    names = {s.name for s in summarize_trace(str(tmp_path), top=100,
                                             device_only=False)}
    assert "cudaLaunchKernel" in names
    assert "PyTorch Profiler (0)" not in names
    print_summary(stats)  # formatting must not raise


def test_cpu_trace_falls_back_to_every_event(tmp_path):
    host_only = [e for e in HANDMADE if e.get("cat") not in (
        "kernel", "gpu_memset")]
    _write_trace(tmp_path / "cpu.pt.trace.json", host_only)
    stats = summarize_trace(str(tmp_path))
    assert [s.name for s in stats] == ["aten::mm", "cudaLaunchKernel"]


def _x(cat, name, ts, dur, tid=1, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 0 if cat == "kernel"
         else 1, "tid": tid, "ts": ts, "dur": dur}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def test_step_breakdown_reads_the_train_spans():
    events = [
        _x("Trace", "PyTorch Profiler (0)", 0, 10000.0),
        _x("user_annotation", TRAIN_SPAN, 0, 1000.0),
        _x("cpu_op", "aten::mm", 100, 300.0),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 50.0, correlation=1),
        _x("cpu_op", "aten::add", 500, 100.0, tid=2),
        _x("user_annotation", TRAIN_SPAN, 3000, 1000.0),
        _x("cuda_driver", "cuLaunchKernel", 3100, 20.0, correlation=2),
        # Between the spans (a validation pass): left out.
        _x("cpu_op", "aten::mm", 1500, 700.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1600, 50.0, correlation=3),
        # Kernels: two launched in the spans (one of them running past
        # its span's end), one launched between, one with no correlation.
        _x("kernel", "gemm", 250, 400.0, tid=7, correlation=1),
        _x("kernel", "order_stat_cluster_kernel", 3990, 60.0, tid=7,
           correlation=2),
        _x("kernel", "gemm", 1700, 900.0, tid=7, correlation=3),
        _x("gpu_memset", "Memset (Device)", 3200, 40.0, tid=7),
    ]
    host, device, wall = span_events(events, TRAIN_SPAN)
    assert wall == 2000.0
    assert sorted(e["name"] for e in device) == [
        "Memset (Device)", "gemm", "order_stat_cluster_kernel"]
    assert sum(e["name"] == "aten::mm" for e in host) == 1
    got = step_breakdown(events, steps=2, span=TRAIN_SPAN)
    # Host self time of the ops in the spans (the spans themselves are
    # windows, not ops): aten::mm less its launch, the launches, and the
    # op on the other thread.
    assert got["host_ms_per_step"] == pytest.approx(
        (250 + 50 + 20 + 100) / 1e3 / 2)
    assert TRAIN_SPAN not in {e["name"] for e in host}
    assert got["device_ms_per_step"] == pytest.approx(0.5 / 2)
    assert got["share"] == pytest.approx(500 / 2000)
    assert got["top_device_kernels_ms_per_step"][0] == ["gemm", 0.2]
    # Without the span: every event, over the profiler's window.
    whole = step_breakdown(events, steps=2)
    assert whole["device_ms_per_step"] == pytest.approx(1.4 / 2)
    assert whole["share"] == pytest.approx(1400 / 10000)


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="trace.json"):
        summarize_trace(str(tmp_path))


def test_profile_fn_captures_real_ops(tmp_path, capsys):
    a = torch.from_numpy(np.random.RandomState(0).randn(64, 64)
                         .astype(np.float32))
    calls = []

    def fn():
        calls.append(1)
        return torch.tanh(a @ a)

    stats = profile_fn(fn, iters=3, trace_dir=str(tmp_path / "tr"),
                       device="cpu")
    assert len(calls) == 4  # the warm-up, then 3 traced
    assert stats and all(s.total_us > 0 for s in stats)
    by_name = {s.name: s for s in stats}
    assert by_name["aten::tanh"].count == 3
    path = latest_trace_file(str(tmp_path))
    assert path.endswith(".pt.trace.json")
    assert any(e.get("cat") == "cpu_op" for e in load_events(path))

    profile_step.main([str(tmp_path), "--top", "3", "--all-tracks"])
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["op", "total", "ms", "count", "%"]
    assert len(table) == 4


def _count(trace_dir, name):
    """Complete events named ``name`` in the trace, and among the host
    events inside its ``span``s."""
    events = load_events(latest_trace_file(trace_dir))
    assert sum(e.get("name") == TRAIN_SPAN for e in events
               if e.get("ph") == "X") == 1
    host, _, _ = span_events(events, TRAIN_SPAN)
    return (sum(1 for e in events if e.get("ph") == "X"
                and e.get("name") == name),
            sum(e.get("name") == name for e in host))


def test_classifier_profile_dir_traces_the_first_epoch(tmp_path):
    prof = str(tmp_path / "prof")
    _, results = classifier_main([
        "--use-rpb", "--epochs", "2", "--batch-size", "64",
        "--subset-fraction", "0.004", "--profile-dir", prof,
        "--checkpoint-dir", str(tmp_path / "ck"), "--plots-dir",
        str(tmp_path / "plots"), "--data-dir", str(tmp_path / "data"),
        "--device", "cpu"])
    steps = len(results["step_losses"][0])
    assert steps == 3
    # One update of the student and one of the teacher a step.
    assert _count(prof, "aten::_foreach_addcmul_") == (2 * steps, 2 * steps)
    # The validation's forward passes lie outside the span.
    total, in_span = _count(prof, "aten::log_softmax")
    assert total > in_span
    # The launches in the traced window: none on the CPU.
    assert not any(results["profile_launches"].values())
    stats = summarize_trace(prof, top=10)
    assert stats and all(s.total_us > 0 for s in stats)


def test_retrieval_profile_dir_traces_the_first_epoch(tmp_path):
    prof = str(tmp_path / "prof")
    state, _, _ = pretrieval.main([
        "--device", "cpu", "--batch_size", "4", "--embed_dim", "32",
        "--hidden_dim", "64", "--image_size", "32", "--max_seq_length", "8",
        "--synthetic_images", "20", "--epochs", "2", "--use_residual",
        "--output_dir", str(tmp_path / "out"), "--data_dir",
        str(tmp_path / "none"), "--profile_dir", prof])
    steps = len(state["stats"]["step_losses"][0])
    assert steps >= 2
    assert _count(prof, "aten::_foreach_addcmul_") == (steps, steps)
    # The validation's image embeddings lie outside the span.
    total, in_span = _count(prof, "aten::convolution")
    assert total > in_span
    assert not any(state["stats"]["profile_launches"].values())
    stats = summarize_trace(prof, top=10)
    assert stats and all(s.total_us > 0 for s in stats)
