#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``atq_tpu_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with
                                   # one NVIDIA H100 (sm_90a) and nvcc

Phases, one JSON line each; any failure exits non-zero:

  build         compiles the CUDA kernels from atq_tpu_torch/csrc (nvcc).
  kernels       holds each kernel against its plain PyTorch version on the
                card (order statistic bit-exact at every listed size and
                rank; packed matmul within rtol 1e-5 / atol 5e-3, the JAX
                package's own kernel tolerance) and times kernel, plain
                version and a one-call PyTorch yardstick at the serving
                shapes, beside the card's bound for the same work.
  serve_dense   starts the port's HTTP server in-process on a seeded,
                full-width Fashion-MNIST RPB classifier (28x28x1 input,
                3136 -> 128 -> 10 head) written as a JAX-layout .npz, posts
                64 concurrent /predict requests, and checks the answers
                against the same checkpoint on the CPU (rtol/atol 1e-4).
                The head's threshold runs the order-statistic kernel.
  serve_packed  the same with --packed: the head serves from 2-bit planes
                through the packed ternary matmul kernel; also checked
                against dense within the bf16-correction tolerance
                (rtol/atol 2e-2).

Then one line {"kernels": [...]} (launch counts from the serve phases),
the card's name and power limit as nvidia-smi prints them, and the result
line {"ok": true, "device": {...}}. Without a GPU, or without the rest of
the repo beside it, the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NVIDIA H100 SXM published peaks (data sheet): HBM3 rate and the float32
# rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
N_REQUESTS = 64
MAX_BATCH = 32
OS_SIZES = (401408, 802816, 16384, 16385, 2359296)
MM_SHAPES = ((128, 3136), (10, 128), (256, 3136), (10, 256))
MM_RTOL, MM_ATOL = 1e-5, 5e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=100, warmup=10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay warm in L2, as between serving batches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50):
    """Mean device time of ``fn`` per call from torch.profiler: the summed
    time of the kernels (and memsets) it ran. Unlike :func:`time_ms` it
    leaves out the gaps in which the device waits for the host. None when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else None


def timed(fns: dict) -> dict:
    """``{name}_ms`` (CUDA events) and ``{name}_device_ms`` (profiler)."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_device_ms"] = device_ms(fn)
    return out


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(smi: str):
    from atq_tpu_torch.ops._build import build_info, load_library

    t0 = time.perf_counter()
    load_library()
    with open(build_info["library"][:-3] + ".log") as f:
        log = f.read()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "built": build_info["built"],
          "sources": build_info["sources"],
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})


def _os_inputs(gen):
    for n in OS_SIZES:
        yield "randn", n, torch.randn(n, device="cuda", generator=gen).abs()
    n = OS_SIZES[0]
    dups = torch.randint(0, 8, (n,), device="cuda", generator=gen)
    yield "duplicates", n, dups.float() / 4
    yield "zeros", n, torch.zeros(n, device="cuda")


def check_order_stat(gen):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_plain,
        order_statistic_reductions,
    )

    max_err, sum_rel_err, cases = 0.0, 0.0, 0
    for kind, n, x in _os_inputs(gen):
        ranks = sorted({0, 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                        n - 1})
        for r in ranks:
            rank = torch.tensor([r], dtype=torch.int32, device="cuda")
            got = torch.stack(order_statistic_reductions(x, rank))
            want = torch.stack(order_statistic_plain(x, rank))
            torch.cuda.synchronize()
            g, w = got.cpu(), want.cpu()
            if g[0].view(torch.int32) != w[0].view(torch.int32):
                raise AssertionError(f"order_stat {kind} n={n} rank={r}: "
                                     f"{g[0].item()!r} != {w[0].item()!r}")
            if g[1] != w[1]:
                raise AssertionError(f"order_stat max {kind} n={n}: "
                                     f"{g[1].item()} != {w[1].item()}")
            if abs(g[2] - w[2]) > 1e-6 * abs(w[2]):
                raise AssertionError(f"order_stat sum {kind} n={n}: "
                                     f"{g[2].item()} vs {w[2].item()}")
            max_err = max(max_err, (g[:2] - w[:2]).abs().max().item())
            if w[2] != 0:
                sum_rel_err = max(sum_rel_err,
                                  abs((g[2] - w[2]) / w[2]).item())
            cases += 1
    return max_err, sum_rel_err, cases


def check_matmul(gen):
    from atq_tpu_torch.core.packing import pack_planar
    from atq_tpu_torch.ops.ternary_matmul import (
        ternary_matmul_plain,
        ternary_matmul_planar,
    )

    shapes = [(m, n, k) for m in (1, 7, 32, 128) for n, k in MM_SHAPES]
    shapes.append((128, 128, 8704))  # routes to _kernel_kblocked in JAX
    max_err, cases = 0.0, 0
    for m, n, k in shapes:
        w = torch.randint(-1, 2, (n, k), device="cuda", generator=gen).float()
        planes = pack_planar(w)
        x = torch.randn(m, k, device="cuda", generator=gen)
        for asym, avec in ((False, (0.9, 0.9)), (True, (0.9, 0.4))):
            avec = torch.tensor(avec, device="cuda")
            got = ternary_matmul_planar(x, planes, k, avec, asym)
            want = ternary_matmul_plain(x, planes, k, avec, asym)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=MM_RTOL,
                                       atol=MM_ATOL)
            max_err = max(max_err, (got - want).abs().max().item())
            cases += 1
    return max_err, cases


def time_order_stat(gen, n):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_plain,
        order_statistic_reductions,
    )

    x = torch.randn(n, device="cuda", generator=gen).abs()
    r = int(np.floor(np.float32(0.3) * np.float32(n)))
    rank = torch.tensor([r], dtype=torch.int32, device="cuda")
    b_ms, b_by = bound(4 * n + 4 + 12, 2 * n)  # read x; max and sum
    return {"n": n, "rank": r, "bound_ms": b_ms, "bound_by": b_by,
            **timed({"kernel": lambda: order_statistic_reductions(x, rank),
                     "plain": lambda: order_statistic_plain(x, rank),
                     "library": lambda: torch.kthvalue(x, r + 1)})}


def time_matmul(gen, m, n, k):
    from atq_tpu_torch.core.packing import pack_planar
    from atq_tpu_torch.ops.ternary_matmul import (
        ternary_matmul_plain,
        ternary_matmul_planar,
    )

    w = torch.randint(-1, 2, (n, k), device="cuda", generator=gen).float()
    planes = pack_planar(w)
    x = torch.randn(m, k, device="cuda", generator=gen)
    avec = torch.tensor([0.9, 0.9], device="cuda")
    w_deq = (w * 0.9).contiguous()
    kq = planes.shape[1]
    b_ms, b_by = bound(m * k * 4 + n * kq + 8 + m * n * 4, 2 * m * n * k)
    return {"m": m, "n": n, "k": k, "bound_ms": b_ms, "bound_by": b_by,
            **timed({"kernel": lambda: ternary_matmul_planar(x, planes, k,
                                                             avec),
                     "plain": lambda: ternary_matmul_plain(x, planes, k,
                                                           avec, False),
                     "library": lambda: torch.matmul(x, w_deq.T)})}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    os_err, os_sum_rel_err, os_cases = check_order_stat(gen)
    mm_err, mm_cases = check_matmul(gen)
    timings = {
        "order_stat": [time_order_stat(gen, n) for n in OS_SIZES[:2]],
        "ternary_matmul": [time_matmul(gen, MAX_BATCH, n, k)
                           for n, k in MM_SHAPES[:2]]
        + [time_matmul(gen, 1, n, k) for n, k in MM_SHAPES[:2]],
    }
    emit({"phase": "kernels", "order_stat_cases": os_cases,
          "order_stat_max_abs_err": os_err,  # statistic and max
          "order_stat_sum_max_rel_err": os_sum_rel_err,
          "ternary_matmul_cases": mm_cases,
          "ternary_matmul_max_abs_err": mm_err, "timings": timings})
    return {"order_stat": os_err, "ternary_matmul": mm_err}, timings


def make_checkpoint(tmpdir):
    """A seeded full-width RPB classifier as a JAX-layout .npz. BatchNorm
    statistics are drawn too, and each head layer's alpha is set to the
    quantizer's optimal alpha, as a trained checkpoint would hold it."""
    from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
    from atq_tpu_torch.models.image_classifier import ATQImageClassifier
    from atq_tpu_torch.utils.jax_interop import (
        save_checkpoint,
        to_jax_variables,
    )

    gen = torch.Generator().manual_seed(0)
    model = ATQImageClassifier(use_rpb=True, hidden_size=128,
                               sparsity_target=0.3, device="cpu",
                               generator=gen)
    with torch.no_grad():
        for bn in (model.features.bn1, model.features.bn2):
            bn.running_mean.normal_(0.0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 1.5, generator=gen)
        for layer in (model.classifier_0, model.classifier_3):
            _, a = adaptive_ternary_quantization(
                layer.weight, sparsity_target=layer.sparsity_target)
            layer.alpha.fill_(float(a))
    path = os.path.join(tmpdir, "atq_model_fashion_mnist.npz")
    save_checkpoint(to_jax_variables(model.state_dict()), path)
    return path


def cpu_reference(path, packed, images):
    """The same checkpoint through the port on the CPU (plain versions)."""
    from atq_tpu_torch.data.mnist import FASHION_STATS
    from atq_tpu_torch.serve.__main__ import build_classifier, build_parser
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = build_parser().parse_args(
        ["--task", "classification", "--checkpoint", path, "--use-rpb"]
        + ["--packed"] * packed)
    model = build_classifier(args, load_checkpoint(path), "parity",
                             torch.device("cpu"))
    mean, std = FASHION_STATS
    x = torch.from_numpy(((images - mean) / std)[..., None])
    with torch.inference_mode():
        return model(x).numpy()


def _post(port, image):
    body = json.dumps({"image": image.tolist(), "normalize": True}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", body,
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def _burst(port, images):
    """All requests at once, one client thread each (a closed loop of
    ``len(images)`` clients sending one request); returns the answers with
    their latencies, and the wall time."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(images)) as pool:
        answers = list(pool.map(lambda im: _post(port, im), images))
    return answers, time.perf_counter() - t0


def phase_serve(name, path, packed, images, reference):
    from torch.profiler import ProfilerActivity, profile

    from atq_tpu_torch.ops.order_stat import order_statistic_reductions
    from atq_tpu_torch.ops.ternary_matmul import ternary_matmul_planar
    from atq_tpu_torch.serve.__main__ import build_server
    from atq_tpu_torch.serve.http import start_in_thread

    counters = {"order_stat": order_statistic_reductions,
                "ternary_matmul": ternary_matmul_planar}
    for fn in counters.values():
        fn.launches = 0
    httpd, servers, info = build_server(
        ["--task", "classification", "--checkpoint", path, "--use-rpb",
         "--port", "0", "--max_batch", str(MAX_BATCH)] + ["--packed"] * packed)
    thread = start_in_thread(httpd)
    try:
        _post(info["port"], images[0])  # first batch: cuDNN set-up
        answers, wall = _burst(info["port"], images)
        # A second, traced burst for the device's busy share; the
        # end-to-end numbers above come from the untraced one.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, traced_wall = _burst(info["port"], images)
            torch.cuda.synchronize()
        stats = dict(servers[0].stats)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        for s in servers:
            s.stop()
    launches = {k: fn.launches for k, fn in counters.items()}
    busy_s = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()) / 1e6

    logits = np.asarray([a["logits"] for a, _ in answers], np.float32)
    lat = np.asarray([t for _, t in answers])
    if logits.shape != (N_REQUESTS, 10) or not np.isfinite(logits).all():
        raise AssertionError(f"{name}: bad logits {logits.shape}")
    np.testing.assert_allclose(logits, reference, rtol=1e-4, atol=1e-4,
                               err_msg=f"{name} vs the CPU plain path")
    kernel = "ternary_matmul" if packed else "order_stat"
    if launches[kernel] == 0:
        raise AssertionError(f"{name}: {kernel} kernel never launched")
    if stats["primary_failures"] or stats["fallback_batches"]:
        raise AssertionError(f"{name}: engine failures {stats}")
    emit({"phase": name, "requests": N_REQUESTS, "failed": 0,
          "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
          "p50_ms": float(np.percentile(lat, 50)),
          # the highest percentile with at least 10 samples beyond it
          "p84_ms": float(np.percentile(lat, 84)),
          "p99_ms": float(np.percentile(lat, 99)),
          "batches": stats["batches"], "launches": launches,
          "traced_wall_s": traced_wall,
          "device_busy_share": (busy_s / traced_wall if busy_s else None),
          "max_abs_err_vs_cpu": float(np.abs(logits - reference).max())})
    return logits, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from atq_tpu_torch.data.mnist import synthetic_test_set
    from atq_tpu_torch.utils.platform import resolve_device

    resolve_device("cuda")  # TF32 off for the cuDNN convs and matmuls
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    phase_build(smi)
    errs, timings = phase_kernels()

    images = synthetic_test_set("fashion_mnist", N_REQUESTS)[0].astype(
        np.float32) / 255.0
    with tempfile.TemporaryDirectory() as tmp:
        path = make_checkpoint(tmp)
        refs = {p: cpu_reference(path, p, images) for p in (False, True)}
        dense, dense_launches = phase_serve("serve_dense", path, False,
                                            images, refs[False])
        packed, packed_launches = phase_serve("serve_packed", path, True,
                                              images, refs[True])
    np.testing.assert_allclose(packed, dense, rtol=2e-2, atol=2e-2,
                               err_msg="packed vs dense")

    sources = {
        "order_stat": ("atq_tpu_torch/csrc/order_stat.cu",
                       "atq_tpu/ops/order_stat.py:44 (_kernel)",
                       dense_launches["order_stat"]),
        "ternary_matmul": ("atq_tpu_torch/csrc/ternary_matmul.cu",
                           "atq_tpu/ops/ternary_matmul.py:85 (_kernel), "
                           ":207 (_kernel_kblocked)",
                           packed_launches["ternary_matmul"]),
    }
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        t = timings[name][0]  # the serving shape of the main path
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": errs[name], "ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "device_ms": t["kernel_device_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
