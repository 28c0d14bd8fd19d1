"""The yardstick on the CPU: FLOP and byte counts against hand-worked
shapes, and the per-layer readers on a canned trace."""

from __future__ import annotations

import pytest

from perfbench import flops
from perfbench.harness import Run
from perfbench.trace import Trace


def test_analytic_step_flops_by_hand():
    # embed 2, ffn 4, 1 layer, seq 3, batch 1, 5 classes: per layer
    # 2·3·(4·4 + 2·2·4) + 4·1·9·2 = 264, the head 2·1·2·5 = 20, times 3.
    assert flops.analytic_step_flops(2, 4, 1, 3, 1, 5) == 3.0 * 284


def test_analytic_step_flops_is_the_programs():
    from atq_tpu_torch.train.scale import analytic_step_flops

    for e, f, h, n, s, b in ((768, 3072, 12, 12, 512, 64),
                             (1024, 4096, 16, 24, 512, 32),
                             (768, 3072, 12, 12, 128, 256)):
        assert flops.analytic_step_flops(e, f, n, s, b, 1000) \
            == analytic_step_flops(e, f, h, n, s, b)


def test_attention_work_by_hand():
    # B 2, H 3, S 4, D 5, 6 layers, 4 bytes: B·H·S·D = 120;
    # operations 12·120·4·6, bytes 8·120·4·6.
    assert flops.attention_work(2, 3, 4, 5, 6, 4) == (34560.0, 23040.0)
    assert flops.attention_work(2, 3, 4, 5, 6, 2)[1] == 11520.0


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(989e12, 0.0, flops.PEAK_BF16) == 1.0
    assert flops.roofline_seconds(0.0, 3.35e12, flops.PEAK_BF16) == 1.0
    assert flops.roofline_seconds(989e12, 6.7e12, flops.PEAK_BF16) == 2.0


ATTN_F32 = "void attn_fwd_kernel<float, 64>(float const*, float const*)"
ATTN_BWD = "void attn_bwd_rows_kernel<float, 64>(float const*)"
GEMM = "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN"
ELT = "void at::native::vectorized_elementwise_kernel<4, float>(int)"


def canned_events():
    """Two steps: a span from 0 to 1,000 µs; kernels at 100–300 (attention
    forward), 250–400 (GEMM, overlapping it), 600–700 (attention
    backward), 900–1,100 (elementwise, past the span's end); a host op
    under the gap 400–600 and an inner one under the first gap."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    return [
        x("PyTorch Profiler (0)", "Trace", -50, 2000),
        x("perfbench.window", "user_annotation", 0, 1000),
        x("aten::step", "cpu_op", 0, 1000),
        x("aten::copy_", "cpu_op", 20, 60),
        x("aten::sort", "cpu_op", 420, 150),
        x(ATTN_F32, "kernel", 100, 200),
        x(GEMM, "kernel", 250, 150),
        x(ATTN_BWD, "kernel", 600, 100),
        x("Memset (Device)", "gpu_memset", 700, 50),
        x(ELT, "kernel", 900, 200),
    ]


@pytest.fixture
def run():
    r = Run({"hidden_size": 64, "intermediate_size": 128,
             "num_attention_heads": 2, "num_hidden_layers": 1,
             "num_classes": 10}, {"seq": 8, "batch": 2})
    r.trace = Trace.from_events(canned_events(), steps=2)
    return r


def test_trace_window_and_busy_share(run):
    t = run.trace
    assert (t.start_us, t.end_us) == (0.0, 1100.0)
    # busy: 100–400, 600–750, 900–1,100
    assert t.busy_us == 650.0
    assert len(t.kernels) == 4 and len(t.device) == 5
    assert run.metric("device.idle_share").read(run) == pytest.approx(
        100.0 * 450 / 1100)
    assert run.metric("step.launches").read(run) == 2.0


def test_kernels_grouped_by_name(run):
    assert run.metric("attn.device_ms").read(run) == pytest.approx(0.15)
    assert run.metric("gemm.device_ms").read(run) == pytest.approx(0.075)
    # the elementwise kernel only: memsets are not kernels
    assert run.metric("eltwise.device_ms").read(run) == pytest.approx(0.1)


def test_attention_roofline_on_the_canned_trace(run):
    # B 2, H 2, S 8, D 32, 1 layer, float32 by the kernels' names.
    ops, nbytes = flops.attention_work(2, 2, 8, 32, 1, 4)
    need = max(ops / flops.PEAK_TF32, nbytes / flops.HBM_BYTES_PER_S)
    assert run.metric("attn.roofline").read(run) == pytest.approx(
        100.0 * need / 0.15e-3)


def test_attention_peak_follows_the_kernels_dtype(run):
    roofline = run.metric("attn.roofline")
    assert roofline.is_float32(ATTN_F32)
    assert not roofline.is_float32(
        "void attn_fwd_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*)")
    assert roofline.is_float32("fmha_cutlassF_f32_aligned_64x64_rf_sm80")
    assert not roofline.is_float32("flash_fwd_kernel<cutlass::bfloat16_t>")


def test_step_mfu_over_the_traced_window(run):
    f = flops.analytic_step_flops(64, 128, 1, 8, 2, 10)
    assert run.metric("step.mfu").read(run) == pytest.approx(
        100.0 * f / (1100e-6 / 2) / flops.PEAK_BF16)


def test_idle_gaps_named_by_the_innermost_host_op(run):
    gaps = dict(run.trace.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(100e-6)   # 0–100
    assert gaps["aten::sort"] == pytest.approx(200e-6)    # 400–600
    assert gaps["aten::step"] == pytest.approx(150e-6)    # 750–900
    assert sum(gaps.values()) == pytest.approx(450e-6)


def test_readers_find_nothing_without_a_trace():
    r = Run({}, {})
    for name in ("step.mfu", "step.launches", "attn.roofline",
                 "attn.device_ms", "gemm.device_ms", "eltwise.device_ms",
                 "device.idle_share", "tokens_per_s", "peak_mem_gib"):
        assert r.metric(name).read(r) is None
