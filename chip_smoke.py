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
  train_dense   python -m atq_tpu_torch.train's own main() on the README
                recipe (--use-rpb --distill --use-l1 --clip-grad, batch
                256, --subset-fraction 0.25: 46 steps an epoch, 2 epochs,
                seed 0): imgs/s and step-time p50 per epoch, kernel
                launches per step (order statistic: 1), the device busy
                share over the traced second epoch (and its top host ops
                and device kernels per step), first/last step loss,
                val/test accuracy. Before it, step 0 of the co-trained step
                (dropout 0, no augmentation) on the card against the same
                step on the CPU: losses within 1e-5 relative, every
                gradient within rtol 1e-4 and an atol of 1e-5 times the
                model's largest |gradient| (at least 1e-5): the ATQ loss
                is ~2e3 at init (saturated CE), so its gradients are
                large; cuDNN sums a conv's gradients over 256x28x28
                positions in another order than the CPU, and the conv
                biases before a train-mode BatchNorm have a true gradient
                of 0 that both sides compute as cancellation noise.
  train_fused   the same run with ATQ_FUSED=1 (forward, dx and dW/dalpha of
                both head layers through the fused kernels: 2 launches
                each per step), then 3 steps without --use-rpb so the
                no-mask variants run; before it, fused step 0 against dense
                step 0 on the card, same tolerances.

The fused kernels are held against their plain versions in phase kernels
at the recipe shapes (256x128x3136, 256x10x128), wider (256x256x3136),
ragged (7x24x100) and a batch past the JAX package's resident limit
(2304x128x3136), with and without the mask, parity and STE: y, dx, dw
within rtol/atol 1e-4 (f32 sums in another order than cuBLAS over K =
3136), dalpha within 1e-4 relative.

Then one line {"kernels": [...]} (launch counts from the main-path phase
that runs each kernel: serve_dense, serve_packed, train_fused),
the card's name and power limit as nvidia-smi prints them, and the result
line {"ok": true, "device": {...}}. Without a GPU, or without the rest of
the repo beside it, the script exits non-zero and prints no result.
"""

import contextlib
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
FUSED_SHAPES = ((256, 128, 3136), (256, 10, 128), (256, 256, 3136),
                (7, 24, 100), (2304, 128, 3136))
FUSED_TOL = 1e-4  # rtol/atol on y, dx, dw; relative on dalpha
STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
RECIPE = ["--use-rpb", "--distill", "--use-l1", "--clip-grad",
          "--batch-size", "256", "--seed", "0"]


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


def _device_us(events):
    """Summed device time (us) of the kernels (and memsets) among profiler
    events. Only device-side events count: a CPU op's self device time is
    the time of the kernels it launched, which appear as events of their
    own."""
    from torch.autograd import DeviceType

    return sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if e.device_type == DeviceType.CUDA)


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
    total_us = _device_us(prof.key_averages())
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


def _fused_inputs(gen, m, n, k, with_mask):
    """Inputs at a head layer's shape: x like post-ReLU features, a small
    weight, the quantizer's threshold at sparsity 0.3, alpha 0.017."""
    from atq_tpu_torch.core.quantize import ternary_threshold
    from atq_tpu_torch.ops.fused_linear import scalars

    x = torch.randn(m, k, device="cuda", generator=gen).clamp_(min=0)
    w = torch.randn(n, k, device="cuda", generator=gen) * 0.02
    g = torch.randn(m, n, device="cuda", generator=gen) * 0.01
    mask = (torch.rand(n, k, device="cuda", generator=gen) < 0.05
            if with_mask else None)
    thr = ternary_threshold(w, sparsity_target=0.3)
    return x, w, g, mask, scalars(torch.full((1,), 0.017, device="cuda"),
                                  thr)


def _err(name, got, want):
    torch.testing.assert_close(got, want, rtol=FUSED_TOL, atol=FUSED_TOL,
                               msg=lambda m: f"{name}: {m}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def check_fused(gen):
    from atq_tpu_torch.ops import fused_linear as fl

    errs = {"fused_forward": 0.0, "fused_dx": 0.0, "fused_dwda": 0.0}
    da_rel, cases = 0.0, 0
    for m, n, k in FUSED_SHAPES:
        for with_mask in (True, False):
            x, w, g, mask, scal = _fused_inputs(gen, m, n, k, with_mask)
            tag = f"{m}x{n}x{k} mask={with_mask}"
            errs["fused_forward"] = max(errs["fused_forward"], _err(
                f"forward {tag}", fl.fused_linear_forward(x, w, mask, scal),
                fl.forward_plain(x, w, mask, scal)))
            errs["fused_dx"] = max(errs["fused_dx"], _err(
                f"dx {tag}", fl.fused_linear_dx(g, w, mask, scal),
                fl.dx_plain(g, w, mask, scal)))
            for ste in (False, True):
                dw, da = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
                dw_p, da_p = fl.dwda_plain(g, x, w, mask, scal, ste)
                errs["fused_dwda"] = max(errs["fused_dwda"], _err(
                    f"dw {tag} ste={ste}", dw, dw_p))
                if mask is None and not ste and dw.any():
                    raise AssertionError(f"dw {tag}: parity without a "
                                         "mask must be exact zeros")
                rel = abs(da.item() - da_p.item()) / abs(da_p.item())
                if rel > FUSED_TOL:
                    raise AssertionError(f"dalpha {tag} ste={ste}: "
                                         f"{da.item()} vs {da_p.item()}")
                da_rel = max(da_rel, rel)
                cases += 1
    torch.cuda.synchronize()
    return errs, da_rel, cases


def time_fused(gen, m, n, k):
    """Kernel, plain version and the one-call cuBLAS yardstick on a
    prebuilt w_eff, for each of the three kernels, with the mask."""
    from atq_tpu_torch.ops import fused_linear as fl

    x, w, g, mask, scal = _fused_inputs(gen, m, n, k, True)
    w_eff = fl._w_eff(w, mask, scal[0], scal[1])[0].contiguous()
    wm = n * k * 4 + n * k + 8  # w, the bool mask, [alpha, thr]
    flops = 2 * m * n * k
    out = {}
    for name, nbytes, fns in (
            ("fused_forward", m * k * 4 + wm + m * n * 4,
             {"kernel": lambda: fl.fused_linear_forward(x, w, mask, scal),
              "plain": lambda: fl.forward_plain(x, w, mask, scal),
              "library": lambda: torch.matmul(x, w_eff.T)}),
            ("fused_dx", m * n * 4 + wm + m * k * 4,
             {"kernel": lambda: fl.fused_linear_dx(g, w, mask, scal),
              "plain": lambda: fl.dx_plain(g, w, mask, scal),
              "library": lambda: torch.matmul(g, w_eff)}),
            ("fused_dwda", m * n * 4 + m * k * 4 + wm + n * k * 4 + 4,
             {"kernel": lambda: fl.fused_linear_dwda(g, x, w, mask, scal,
                                                     False),
              "plain": lambda: fl.dwda_plain(g, x, w, mask, scal, False),
              "library": lambda: torch.matmul(g.T, x)})):
        b_ms, b_by = bound(nbytes, flops)
        out[name] = {"m": m, "n": n, "k": k, "bound_ms": b_ms,
                     "bound_by": b_by, **timed(fns)}
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    os_err, os_sum_rel_err, os_cases = check_order_stat(gen)
    mm_err, mm_cases = check_matmul(gen)
    fused_errs, da_rel, fused_cases = check_fused(gen)
    timings = {
        "order_stat": [time_order_stat(gen, n) for n in OS_SIZES[:2]],
        "ternary_matmul": [time_matmul(gen, MAX_BATCH, n, k)
                           for n, k in MM_SHAPES[:2]]
        + [time_matmul(gen, 1, n, k) for n, k in MM_SHAPES[:2]],
    }
    for shape in FUSED_SHAPES[:2]:  # the recipe's two head layers
        for name, t in time_fused(gen, *shape).items():
            timings.setdefault(name, []).append(t)
    emit({"phase": "kernels", "order_stat_cases": os_cases,
          "order_stat_max_abs_err": os_err,  # statistic and max
          "order_stat_sum_max_rel_err": os_sum_rel_err,
          "ternary_matmul_cases": mm_cases,
          "ternary_matmul_max_abs_err": mm_err,
          "fused_cases": fused_cases, "fused_max_abs_err": fused_errs,
          "fused_dalpha_max_rel_err": da_rel, "timings": timings})
    return {"order_stat": os_err, "ternary_matmul": mm_err,
            **fused_errs}, timings


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
    busy_s = _device_us(prof.key_averages()) / 1e6

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


def _reset_launches():
    from atq_tpu_torch.ops import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0


class _NoUpdate:
    """An optimizer that leaves the parameters (and their .grad) alone."""

    def step(self):
        pass


def _step0(device, fused, batch):
    """Loss, teacher loss and every gradient of step 0 of the co-trained
    step on ``device``, from the seed-0 init (dropout 0, no augmentation,
    epoch-0 sparsity 0.05, L1 weight 2e-5)."""
    from atq_tpu_torch.models.image_classifier import (
        ATQImageClassifier,
        BaselineCNNClassifier,
    )
    from atq_tpu_torch.train.classifier import (
        ClassifierConfig,
        _set_all_sparsity,
        build_train_step,
    )

    gen = torch.Generator().manual_seed(0)
    atq = ATQImageClassifier(use_rpb=True, dropout_rate=0.0, device=device,
                             generator=gen)
    base = BaselineCNNClassifier(dropout_rate=0.0, device=device,
                                 generator=gen)
    _set_all_sparsity(atq, 0.05)
    atq.train()
    base.train()
    cfg = ClassifierConfig(use_rpb=True, distill=True, use_l1=True,
                           clip_grad=True, device_augment=False)
    os.environ["ATQ_FUSED"] = "1" if fused else "0"
    try:
        step = build_train_step(atq, base, _NoUpdate(), _NoUpdate(), cfg)
        images, labels = batch
        m = step(torch.from_numpy(images).to(device),
                 torch.from_numpy(labels).to(device).long(), 2e-5)
    finally:
        os.environ["ATQ_FUSED"] = "0"
    grads = {}
    for prefix, model in (("atq.", atq), ("base.", base)):
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[prefix + name] = g.detach().cpu()
    return float(m["loss"]), float(m["base_loss"]), grads


def _compare_step0(what, got, want):
    """Largest relative loss difference and largest gradient error; raises
    past the tolerances."""
    loss_rel = 0.0
    for a, b, name in ((got[0], want[0], "loss"), (got[1], want[1],
                                                   "base_loss")):
        rel = abs(a - b) / abs(b)
        if rel > STEP_LOSS_RTOL:
            raise AssertionError(f"{what} step 0 {name}: {a} vs {b}")
        loss_rel = max(loss_rel, rel)
    # Largest |difference| over the model's largest |gradient|.
    scales = {}
    for name, g in want[2].items():
        model = name.split(".", 1)[0]
        scales[model] = max(scales.get(model, 1.0), g.abs().max().item())
    grad_err = 0.0
    for name, g in want[2].items():
        scale = scales[name.split(".", 1)[0]]
        torch.testing.assert_close(got[2][name], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   msg=lambda m: f"{what} grad {name}: {m}")
        grad_err = max(grad_err,
                       (got[2][name] - g).abs().max().item() / scale)
    return {"loss_max_rel_diff": loss_rel,
            "grad_max_abs_diff_over_model_max": grad_err,
            "grad_scale": scales, "grad_leaves": len(want[2])}


def _step0_batch():
    from atq_tpu_torch.data.mnist import FASHION_STATS, _synthetic

    images, labels = _synthetic("fashion_mnist", n_train=256, n_test=1)[:2]
    mean, std = FASHION_STATS
    x = ((images.astype(np.float32) / 255.0 - mean) / std)[..., None]
    return x.astype(np.float32), labels.astype(np.int32)


def _train_run(argv, trace_epoch=None):
    """``python -m atq_tpu_torch.train``'s main() with kernel counts reset
    before it and read after it, the epoch ``trace_epoch`` traced."""
    from torch.profiler import ProfilerActivity, profile

    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.__main__ import main as train_main

    traced = {}

    def epoch_context(epoch):
        if epoch != trace_epoch:
            return contextlib.nullcontext()
        traced["prof"] = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
        return traced["prof"]

    _reset_launches()
    t0 = time.perf_counter()
    _, results = train_main(argv, epoch_context=epoch_context)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    busy = None
    if "prof" in traced:
        events = traced["prof"].key_averages()
        busy_s = _device_us(events) / 1e6
        steps = len(results["step_losses"][trace_epoch])
        busy = {"share": busy_s / results["epoch_seconds"][trace_epoch],
                **_breakdown(events, steps)}
    return results, launches, wall, busy


def _breakdown(events, steps, top=8):
    """Per training step of the traced epoch: host time, device time, the
    host ops with the most self CPU time and the device kernels with the
    most device time (ms)."""
    from torch.autograd import DeviceType

    def per_step(attr, device_type):
        rows = sorted(((getattr(e, attr, 0.0), e.key) for e in events
                       if e.device_type == device_type), reverse=True)[:top]
        return [[name, t / 1e3 / steps] for t, name in rows if t > 0]

    return {"steps": steps,
            "host_ms_per_step": sum(e.self_cpu_time_total for e in events
                                    if e.device_type == DeviceType.CPU)
            / 1e3 / steps,
            "device_ms_per_step": _device_us(events) / 1e3 / steps,
            "top_host_ops_ms_per_step": per_step("self_cpu_time_total",
                                                 DeviceType.CPU),
            "top_device_kernels_ms_per_step": per_step(
                "self_device_time_total", DeviceType.CUDA)}


def _check_run(name, results, per_step):
    losses = [x for epoch in results["step_losses"] for x in epoch]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite or missing step losses")
    first, last = results["epoch_losses"][0], results["epoch_losses"][-1]
    if not last < first:
        raise AssertionError(f"{name}: last-epoch mean loss {last} not "
                             f"below the first {first}")
    for epoch, got in enumerate(results["launches_per_step"]):
        for kernel, want in per_step.items():
            if got[kernel] != want:
                raise AssertionError(f"{name} epoch {epoch}: {kernel} "
                                     f"{got[kernel]} launches per step, "
                                     f"expected {want}")


def _run_summary(results, wall, busy):
    return {"wall_s": wall,
            "imgs_per_s": results["imgs_per_sec"],
            "step_ms_p50": [float(np.percentile(t, 50))
                            for t in results["step_ms"]],
            "launches_per_step": results["launches_per_step"],
            "traced_epoch": busy,
            "loss_first_step": results["step_losses"][0][0],
            "loss_last_step": results["step_losses"][-1][-1],
            "epoch_losses": results["epoch_losses"],
            "val_acc": results["val_accuracies"],
            "test_acc": results["test_acc"],
            "baseline_test_acc": results["baseline_test_acc"]}


def phase_train(name, fused, tmp, batch, step0_ref):
    """One training phase; ``step0_ref`` is the step-0 result it is held
    to (the CPU for dense, dense on the card for fused)."""
    step0 = _step0("cuda", fused, batch)
    step0_check = _compare_step0(name, step0, step0_ref)
    argv = RECIPE + ["--epochs", "2", "--subset-fraction", "0.25",
                     "--checkpoint-dir", os.path.join(tmp, name),
                     "--plots-dir", os.path.join(tmp, name, "plots"),
                     "--data-dir", os.path.join(tmp, "data")]
    os.environ["ATQ_FUSED"] = "1" if fused else "0"
    try:
        results, launches, wall, busy = _train_run(argv, trace_epoch=1)
        per_step = {"order_stat": 1, "fused_forward": 2 * fused,
                    "fused_dx": 2 * fused, "fused_dwda": 2 * fused}
        _check_run(name, results, per_step)
        line = {"phase": name, "steps_per_epoch": len(
            results["step_losses"][0]), **_run_summary(results, wall, busy),
            "launches": launches, "step0_vs_" + ("dense" if fused else "cpu"):
            step0_check}
        if fused:
            # Three steps of the TernaryLinear head: the no-mask variants.
            nomask, nomask_launches, _, _ = _train_run(
                ["--distill", "--batch-size", "256", "--epochs", "1",
                 "--subset-fraction", "0.0165", "--checkpoint-dir",
                 os.path.join(tmp, name + "_nomask"), "--plots-dir",
                 os.path.join(tmp, name + "_nomask", "plots"),
                 "--data-dir", os.path.join(tmp, "data")])
            steps = len(nomask["step_losses"][0])
            if steps != 3 or not np.isfinite(nomask["step_losses"][0]).all():
                raise AssertionError(f"{name} no-mask run: {nomask}")
            for k in ("fused_forward", "fused_dx", "fused_dwda"):
                if nomask["launches_per_step"][0][k] != 2:
                    raise AssertionError(f"{name} no-mask: {k} per step "
                                         f"{nomask['launches_per_step']}")
            line["nomask_run"] = {"steps": steps,
                                  "losses": nomask["step_losses"][0],
                                  "launches": nomask_launches}
    finally:
        os.environ["ATQ_FUSED"] = "0"
    emit(line)
    return launches, step0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from atq_tpu_torch.data.mnist import synthetic_test_set
    from atq_tpu_torch.utils.platform import resolve_device

    resolve_device("cuda")  # TF32 off for the cuDNN convs and matmuls
    os.environ["ATQ_NO_DOWNLOAD"] = "1"  # the synthetic data; no network
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
        batch = _step0_batch()
        cpu_step0 = _step0("cpu", False, batch)
        _, dense_step0 = phase_train("train_dense", False, tmp, batch,
                                     cpu_step0)
        fused_launches, _ = phase_train("train_fused", True, tmp, batch,
                                        dense_step0)

    sources = {
        "order_stat": ("atq_tpu_torch/csrc/order_stat.cu",
                       "atq_tpu/ops/order_stat.py:44 (_kernel)",
                       dense_launches["order_stat"]),
        "ternary_matmul": ("atq_tpu_torch/csrc/ternary_matmul.cu",
                           "atq_tpu/ops/ternary_matmul.py:85 (_kernel), "
                           ":207 (_kernel_kblocked)",
                           packed_launches["ternary_matmul"]),
        "fused_forward": ("atq_tpu_torch/csrc/fused_linear.cu",
                          "atq_tpu/ops/fused_linear.py:90 (_fwd_kernel), "
                          ":107 (_fwd_kernel_nomask)",
                          fused_launches["fused_forward"]),
        "fused_dx": ("atq_tpu_torch/csrc/fused_linear.cu",
                     "atq_tpu/ops/fused_linear.py:165 (_dx_kernel), "
                     ":182 (_dx_kernel_nomask)",
                     fused_launches["fused_dx"]),
        "fused_dwda": ("atq_tpu_torch/csrc/fused_linear.cu",
                       "atq_tpu/ops/fused_linear.py:243 (_dwda_kernel), "
                       ":270 (_dwda_kernel_nomask)",
                       fused_launches["fused_dwda"]),
    }
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        t = timings[name][0]  # the main path's (first) shape
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
