#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``atq_tpu_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with
                                   # one NVIDIA H100 (sm_90a) and nvcc
    python3 chip_smoke.py --compare DIR [OUT]
                                   # the packed kernels of another checkout
                                   # (DIR) against this tree's, in turns
                                   # DIR, this, this, DIR (device ms; raw
                                   # rows in OUT, default outputs/compare)

Phases, one JSON line each; any failure exits non-zero:

  build         compiles the CUDA kernels from atq_tpu_torch/csrc (nvcc);
                ptxas's registers and spills, and the HMMA count of each
                tiled_packed_kernel instantiation (cuobjdump -sass).
  kernels       holds each kernel against its plain PyTorch version on the
                card (order statistic bit-exact at every listed size and
                rank; packed matmul within rtol 1e-5 / atol 5e-3, the JAX
                package's own kernel tolerance) and times kernel, plain
                version and a one-call PyTorch yardstick at the serving
                shapes, beside the card's bound for the same work (the
                packed kernels: bytes, or three bf16 passes a product at
                the tensor-core rate; the others: bytes or f32 operations).
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
  serve_retrieval
                python -m atq_tpu_torch.serve --task retrieval --packed
                --use_residual in-process at the README's widths (ResNet-18
                at 160x160 from the int8 trunk, embed 192, FFN 384, 4 text
                layers, sequence 50) on a seeded checkpoint written as a
                JAX-layout .npz with a vocab.json from the synthetic corpus:
                32 concurrent /embed_image and 32 /embed_text (a burst,
                then a traced burst), 64 /index/add and 16 /search.
                Embeddings within atol 1e-3 of the same checkpoint through
                the port on the CPU (plain versions), /search top-1 ids
                equal wherever the CPU's top-2 gap exceeds 1e-3, and the
                packed-kernel launches equal 26 per text batch and 1 per
                image batch.
  serve_retrieval_pack32
                the same with ATQ_PACK32=1 (planar32 words, kernel 5), also
                within 1e-5 of serve_retrieval.
  serve_dense_correction
                the retrieval encoders and the classifier exported with
                sparse_correction=False (every RPB layer through kernel 4),
                in-process: within 1e-4 of the sparse export on the card
                and 1e-3 of the CPU plain path.
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

  encoder_step0 step 0 of the port's QAT step (python -m
                atq_tpu_torch.train.scale) at bert-base widths (768/3072/12
                heads) with 2 layers, batch 8, sequence 256, each ternary
                layer's alpha set to its optimal alpha: --attn fused
                --hoist in float32 on the card (the batched order statistic
                and the attention kernels) against the CPU's plain
                versions, loss within 1e-5 relative and gradients within
                rtol 1e-4 and 1e-5 of the largest |gradient| (train_dense's
                rule);
                then, on the card under AMP, fused+hoisted against
                einsum+unhoisted: loss within 1e-4, gradients within rtol
                1e-3 and 1e-3 of the largest (the attention is float32 on
                both paths and the bf16 products take the same weights, but
                the two softmaxes sum in another order and a bf16 rounding
                of an activation may flip).
  train_encoder that module's main() with --configs bert-base --attn fused
                --hoist (12 layers, batch 64, sequence 256, AMP, remat
                save_quantized, AdamW 1e-4): 2 warm-up and 8 timed steps on
                one batch; ms per step, tokens/s, MFU against the card's
                bf16 peak, peak memory, the losses (finite, the last below
                the first), launches per step (batched order statistic 6,
                attention forward 24 with remat's recompute, backward 12),
                then the device busy share and top kernels of two traced
                steps.

The batched order statistic is held bit-exact (sum within 1e-6 relative)
against a per-row sort at (12, 589,824), (12, 2,359,296) and (3, 16,385)
with per-row ranks 0, n-1, 0.3n and 1; the attention kernels against their
plain versions at (64, 12, 256, 64) f32, (8, 8, 50, 16) f32 with a padding
bias and a fully padded row, (4, 4, 512, 64) f32 and (4, 4, 256, 64) bf16:
o, dq, dk, dv within rtol/atol 1e-4 (f32) or 2e-2 (bf16).

The planar32 and RPB kernels are held against their plain versions in
phase kernels (rtol 1e-5 / atol 5e-3) at the text tower's (M, K -> N) =
(1600, 192 -> 192), (1600, 192 -> 384), (1600, 384 -> 192),
(1600, 192 -> 96), the image projector's (32, 512 -> 192), the classifier
head's (32, 3136 -> 128), a ragged (7, 100 -> 24) and EDGE_SHAPES; planar32
symmetric and TTQ. The three packed kernels (uint8 planes, planar32, RPB)
are launched twice at each shape and must repeat bit for bit.

The fused kernels are held against their plain versions in phase kernels
at the recipe shapes (256x128x3136, 256x10x128), wider (256x256x3136),
ragged (7x24x100) and a batch past the JAX package's resident limit
(2304x128x3136), with and without the mask, parity and STE: y, dx, dw
within rtol/atol 1e-4 (f32 sums in another order than cuBLAS over K =
3136), dalpha within 1e-4 relative.

Then one line {"kernels": [...]} (launch counts from the main-path phase
that runs each kernel: serve_dense, serve_packed, serve_retrieval_pack32,
serve_dense_correction, train_fused, train_encoder),
the card's name and power limit as nvidia-smi prints them, and the result
line {"ok": true, "device": {...}}. Without a GPU, or without the rest of
the repo beside it, the script exits non-zero and prints no result.
"""

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NVIDIA H100 SXM published peaks (data sheet): HBM3 rate, the float32
# rate outside the tensor cores, and the dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
N_REQUESTS = 64
MAX_BATCH = 32
OS_SIZES = (401408, 802816, 16384, 16385, 2359296)
MM_SHAPES = ((128, 3136), (10, 128), (256, 3136), (10, 256))
MM_RTOL, MM_ATOL = 1e-5, 5e-3
# Edge shapes of the packed kernels, (M, K, N): the eligibility minima
# (N = 8, K = 128), K = 200 (not a multiple of 16 or 32), M = 1 and 17.
EDGE_SHAPES = ((1, 128, 8), (17, 128, 8), (17, 200, 8), (1, 200, 24),
               (17, 200, 40))
FUSED_SHAPES = ((256, 128, 3136), (256, 10, 128), (256, 256, 3136),
                (7, 24, 100), (2304, 128, 3136))
FUSED_TOL = 1e-4  # rtol/atol on y, dx, dw; relative on dalpha
STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# Batched order statistic: bert-base's two stacked weight shapes (q/k/v/out,
# linear1/linear2) and a ragged one.
BATCHED_OS_SHAPES = ((12, 589824), (12, 2359296), (3, 16385))
BERT_SPARSITY = 0.1  # the layers' initial sparsity, min(0.1, 0.3)
# Attention: bert-base's shape first (the main path's, f32 under AMP).
ATTN_CASES = (((64, 12, 256, 64), torch.float32, False),
              ((8, 8, 50, 16), torch.float32, True),
              ((4, 4, 512, 64), torch.float32, False),
              ((4, 4, 256, 64), torch.bfloat16, False))
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Encoder step 0: bert-base widths, 2 layers, batch 8, sequence 256.
ENCODER_STEP0 = (768, 3072, 12, 2, 256, 8, True, True)
AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_GRAD_ATOL = 1e-4, 1e-3, 1e-3
ENCODER_ARGV = ["--configs", "bert-base", "--attn", "fused", "--hoist",
                "--steps", "8"]
ENCODER_PER_STEP = {"batched_order_stat": 6, "fused_attention_fwd": 24,
                    "fused_attention_bwd": 12}
RECIPE = ["--use-rpb", "--distill", "--use-l1", "--clip-grad",
          "--batch-size", "256", "--seed", "0"]
# Kernels 4 (RPB) and 5 (planar32), (M, K, N): the retrieval text tower's
# projections at 32 requests x 50 tokens (q/k/v/out, linear1, linear2,
# attention_pool_0), the image projector, the classifier head, and a ragged
# shape. The first is the main path's shape in the kernels line.
PACKED_SHAPES = ((1600, 192, 192), (1600, 192, 384), (1600, 384, 192),
                 (1600, 192, 96), (32, 512, 192), (32, 3136, 128),
                 (7, 100, 24))
# The retrieval server at the README's widths (README.md): ResNet-18 at
# 160x160, embed 192, FFN 384, 4 text layers of 8 heads, sequence 50.
RETRIEVAL_ARGV = ["--task", "retrieval", "--use_residual", "--packed",
                  "--image_size", "160", "--embed_dim", "192",
                  "--hidden_dim", "384", "--max_seq_length", "50"]
IMAGE_SIZE, SEQ_LEN = 160, 50
N_IMAGES = N_TEXTS = 32  # the burst: 32 /embed_image + 32 /embed_text
N_SEARCHES = 16
# Packed-kernel launches per batch: 4 layers x 6 projections,
# attention_pool_0 and text_projector (attention_pool_2 has N = 1 and takes
# the plain path, as in JAX); the image projector.
TEXT_LAUNCHES, IMAGE_LAUNCHES = 26, 1
RETRIEVAL_ATOL = 1e-3  # card against the CPU plain path (int8 trunk, f32)
# An image's embedding in a burst against the same image sent alone: the
# int8 trunk's activation scale is max|x| over the batch, so the two runs
# quantize the activations on different grids.
BURST_MIN_COSINE = 0.99


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
    leaves out the gaps in which the device waits for the host. A window in
    which the profiler records no device activity (it happens now and then)
    is traced again, twice at most; None if all three record none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = _device_us(prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


def timed(fns: dict) -> dict:
    """``{name}_ms`` (CUDA events) and ``{name}_device_ms`` (profiler)."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_device_ms"] = device_ms(fn)
    return out


def bound(nbytes: float, flops: float, peak_flops=PEAK_F32_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_bf16x3(nbytes: float, m: int, n: int, k: int, products=1):
    """The packed kernels' bound: bytes, or the three bf16 passes of each
    product (6·M·N·K operations a product) at the tensor-core rate."""
    return bound(nbytes, 6 * m * n * k * products, PEAK_BF16_FLOP_PER_S)


def _same_bits(name, fn, first):
    """A second launch must give the first one's bits."""
    again = fn()
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: a second launch differs by "
                             f"{(first - again).abs().max().item()}")


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
                    if "registers" in ln or "spill" in ln],
          "packed_kernel_hmma": _sass_hmma(build_info["library"])})


def _sass_hmma(library):
    """HMMA instructions in each tiled_packed_kernel instantiation's SASS
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "tiled_packed_kernel" not in name:
                name = None
            else:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


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
    shapes += [(m, n, k) for m, k, n in PACKED_SHAPES + EDGE_SHAPES]
    max_err, cases = 0.0, 0
    for m, n, k in shapes:
        w = torch.randint(-1, 2, (n, k), device="cuda", generator=gen).float()
        planes = pack_planar(w)
        x = torch.randn(m, k, device="cuda", generator=gen)
        for asym, avec in ((False, (0.9, 0.9)), (True, (0.9, 0.4))):
            avec = torch.tensor(avec, device="cuda")

            def fn():
                return ternary_matmul_planar(x, planes, k, avec, asym)

            got = fn()
            want = ternary_matmul_plain(x, planes, k, avec, asym)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=MM_RTOL,
                                       atol=MM_ATOL)
            _same_bits(f"matmul {m}x{n}x{k} asym={asym}", fn, got)
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
    # 2 bits a weight of the logical K, not the padding
    b_ms, b_by = bound_bf16x3(m * k * 4 + n * k / 4 + 8 + m * n * 4, m, n, k)
    return {"m": m, "n": n, "k": k, "bound_ms": b_ms, "bound_by": b_by,
            **timed({"kernel": lambda: ternary_matmul_planar(x, planes, k,
                                                             avec),
                     "plain": lambda: ternary_matmul_plain(x, planes, k,
                                                           avec, False),
                     "library": lambda: torch.matmul(x, w_deq.T)})}


def _packed_inputs(gen, m, k, n):
    """x, a ternary (n, k) weight, its uint8 planes and planar32 words,
    and a dense bf16 RPB correction on 5% of the weights."""
    from atq_tpu_torch.core.packing import pack_planar, pack_planar32

    w = torch.randint(-1, 2, (n, k), device="cuda", generator=gen).float()
    x = torch.randn(m, k, device="cuda", generator=gen)
    mask = torch.rand(n, k, device="cuda", generator=gen) < 0.05
    corr = (torch.randn(n, k, device="cuda", generator=gen) * 0.02
            * mask).to(torch.bfloat16)
    return x, w, pack_planar(w), pack_planar32(w), corr


def check_packed_kernels(gen):
    """Kernels 4 and 5 against their plain versions at PACKED_SHAPES and
    EDGE_SHAPES, kernel 5 symmetric and TTQ; each launched twice, the two
    results bit for bit equal."""
    from atq_tpu_torch.ops import ternary_matmul as tm

    errs = {"ternary_matmul32": 0.0, "ternary_matmul_rpb": 0.0}
    cases = 0
    for m, k, n in PACKED_SHAPES + EDGE_SHAPES:
        x, _, planes, words, corr = _packed_inputs(gen, m, k, n)
        for asym, avec in ((False, (0.9, 0.9)), (True, (0.9, 0.4))):
            avec = torch.tensor(avec, device="cuda")

            def fn32():
                return tm.ternary_matmul_planar32(x, words, k, avec, asym)

            got = fn32()
            want = tm.ternary_matmul32_plain(x, words, k, avec, asym)
            errs["ternary_matmul32"] = max(errs["ternary_matmul32"], _err(
                f"matmul32 {m}x{k}->{n} asym={asym}", got, want,
                MM_RTOL, MM_ATOL))
            _same_bits(f"matmul32 {m}x{k}->{n} asym={asym}", fn32, got)
            cases += 1
        avec = torch.tensor((0.9, 0.9), device="cuda")

        def fn_rpb():
            return tm.ternary_matmul_rpb(x, planes, corr, k, avec)

        got = fn_rpb()
        want = tm.ternary_matmul_rpb_plain(x, planes, corr, k, avec)
        errs["ternary_matmul_rpb"] = max(errs["ternary_matmul_rpb"], _err(
            f"rpb {m}x{k}->{n}", got, want, MM_RTOL, MM_ATOL))
        _same_bits(f"rpb {m}x{k}->{n}", fn_rpb, got)
        cases += 1
    torch.cuda.synchronize()
    return errs, cases


def time_packed(gen, m, k, n):
    """The packed kernels (uint8 planes, kernels 4 and 5) at one shape:
    kernel, plain version, and one torch.matmul on the prebuilt dequantized
    weight as the yardstick. The bounds count the logical K (2 bits a
    weight), not the padding; the operations, the three bf16 passes of each
    product on the tensor cores."""
    from atq_tpu_torch.ops import ternary_matmul as tm

    x, w, planes, words, corr = _packed_inputs(gen, m, k, n)
    avec = torch.tensor([0.9, 0.9], device="cuda")
    w_deq = (w * 0.9).contiguous()
    w_rpb = (w * 0.9 + corr.float()).contiguous()
    x_out = m * k * 4 + 8 + m * n * 4  # read x and alpha, write out
    planes_b = n * k / 4
    b32, b32_by = bound_bf16x3(x_out + planes_b, m, n, k)
    # The RPB function also reads the bf16 correction and has two products.
    brpb, brpb_by = bound_bf16x3(x_out + planes_b + n * k * 2, m, n, k,
                                 products=2)
    return {
        "ternary_matmul": {
            "m": m, "n": n, "k": k, "bound_ms": b32, "bound_by": b32_by,
            **timed({"kernel": lambda: tm.ternary_matmul_planar(
                x, planes, k, avec),
                "plain": lambda: tm.ternary_matmul_plain(
                    x, planes, k, avec, False),
                "library": lambda: torch.matmul(x, w_deq.T)})},
        "ternary_matmul32": {
            "m": m, "k": k, "n": n, "bound_ms": b32, "bound_by": b32_by,
            **timed({"kernel": lambda: tm.ternary_matmul_planar32(
                x, words, k, avec),
                "plain": lambda: tm.ternary_matmul32_plain(
                    x, words, k, avec, False),
                "library": lambda: torch.matmul(x, w_deq.T)})},
        "ternary_matmul_rpb": {
            "m": m, "k": k, "n": n, "bound_ms": brpb, "bound_by": brpb_by,
            **timed({"kernel": lambda: tm.ternary_matmul_rpb(
                x, planes, corr, k, avec),
                "plain": lambda: tm.ternary_matmul_rpb_plain(
                    x, planes, corr, k, avec),
                "library": lambda: torch.matmul(x, w_rpb.T)})},
    }


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


def _err(name, got, want, tol=FUSED_TOL, atol=None):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol if atol is None else atol,
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


def check_batched_order_stat(gen):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_batched_plain,
        order_statistic_reductions_batched,
    )

    max_err, sum_rel_err, cases = 0.0, 0.0, 0
    for lead, n in BATCHED_OS_SHAPES:
        x = torch.randn(lead, n, device="cuda", generator=gen).abs()
        x[0] = torch.randint(0, 8, (n,), device="cuda",
                             generator=gen).float() / 4  # duplicates
        picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                 1]
        ranks = torch.tensor([picks[i % 4] for i in range(lead)],
                             dtype=torch.int32, device="cuda")
        got = torch.stack(order_statistic_reductions_batched(x, ranks)).cpu()
        want = torch.stack(order_statistic_batched_plain(x, ranks)).cpu()
        if not torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)):
            raise AssertionError(f"batched order stat ({lead}, {n}): "
                                 f"{got[0]} != {want[0]}")
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"batched max ({lead}, {n})")
        rel = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
        if rel > 1e-6:
            raise AssertionError(f"batched sum ({lead}, {n}): rel {rel}")
        max_err = max(max_err, (got[:2] - want[:2]).abs().max().item())
        sum_rel_err = max(sum_rel_err, rel)
        cases += lead
    return max_err, sum_rel_err, cases


def _attn_inputs(gen, shape, dtype, with_bias):
    from atq_tpu_torch.ops.fused_attention import padding_bias

    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    bias = None
    if with_bias:
        lengths = torch.randint(1, shape[2] + 1, (shape[0],), device="cuda",
                                generator=gen)
        lengths[0] = 0  # one fully padded batch row
        bias = padding_bias(lengths, shape[2])
    return q, k, v, do, bias


def check_attention(gen):
    """Forward and backward kernels against their plain versions; o and
    dq, dk, dv within rtol/atol 1e-4 (float32) or 2e-2 (bfloat16)."""
    from atq_tpu_torch.ops import fused_attention as fa

    errs = {"fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0}
    by_case = []
    for shape, dtype, with_bias in ATTN_CASES:
        q, k, v, do, bias = _attn_inputs(gen, shape, dtype, with_bias)
        scale = 1.0 / float(np.sqrt(shape[3]))
        tol = ATTN_TOL[dtype]
        o = fa.fused_attention_forward(q, k, v, scale, bias)
        if not torch.isfinite(o).all():
            raise AssertionError(f"attention {shape}: non-finite output")
        case = {"shape": shape, "dtype": str(dtype), "bias": with_bias}
        case["fwd"] = _err(f"attention fwd {shape} {dtype}", o.float(),
                           fa.forward_plain(q, k, v, scale, bias).float(),
                           tol)
        grads = fa.fused_attention_backward(q, k, v, scale, bias, do)
        want = fa.backward_plain(q, k, v, scale, bias, do)
        case["bwd"] = max(_err(f"attention d{n} {shape} {dtype}", a.float(),
                               b.float(), tol)
                          for n, a, b in zip("qkv", grads, want))
        errs["fused_attention_fwd"] = max(errs["fused_attention_fwd"],
                                          case["fwd"])
        errs["fused_attention_bwd"] = max(errs["fused_attention_bwd"],
                                          case["bwd"])
        by_case.append(case)
    torch.cuda.synchronize()
    return errs, by_case


def time_batched_order_stat(gen, lead, n):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_batched_plain,
        order_statistic_reductions_batched,
    )

    x = torch.randn(lead, n, device="cuda", generator=gen).abs()
    r = int(np.floor(np.float32(BERT_SPARSITY) * np.float32(n)))
    ranks = torch.full((lead,), r, dtype=torch.int32, device="cuda")
    # read x and the ranks, write (stat, max, sum) per row; max and sum
    b_ms, b_by = bound(4 * lead * n + 4 * lead + 12 * lead, 2 * lead * n)
    return {"lead": lead, "n": n, "rank": r, "bound_ms": b_ms,
            "bound_by": b_by,
            **timed({"kernel": lambda: order_statistic_reductions_batched(
                x, ranks),
                "plain": lambda: order_statistic_batched_plain(x, ranks),
                "library": lambda: torch.kthvalue(x, r + 1, dim=1)})}


def time_attention(gen):
    """bert-base's attention call, (64, 12, 256, 64) float32 without bias:
    kernels, plain versions, and scaled_dot_product_attention (forward, and
    forward+backward for the backward row) as the yardstick."""
    import torch.nn.functional as F

    from atq_tpu_torch.ops import fused_attention as fa

    shape = ATTN_CASES[0][0]
    b, h, s, d = shape
    q, k, v, do, _ = _attn_inputs(gen, shape, torch.float32, False)
    scale = 1.0 / float(np.sqrt(d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
        return torch.autograd.grad(o, leaves, do)

    elems = b * h * s * d
    fwd_ms, fwd_by = bound(4 * elems * 4, 4 * s * s * d * b * h)
    bwd_ms, bwd_by = bound(7 * elems * 4, 10 * s * s * d * b * h)
    return {
        "fused_attention_fwd": {
            "shape": shape, "bound_ms": fwd_ms, "bound_by": fwd_by,
            **timed({"kernel": lambda: fa.fused_attention_forward(
                q, k, v, scale),
                "plain": lambda: fa.forward_plain(q, k, v, scale),
                "library": lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale)})},
        "fused_attention_bwd": {
            "shape": shape, "bound_ms": bwd_ms, "bound_by": bwd_by,
            "library_is": "sdpa forward+backward",
            **timed({"kernel": lambda: fa.fused_attention_backward(
                q, k, v, scale, None, do),
                "plain": lambda: fa.backward_plain(q, k, v, scale, None, do),
                "library": sdpa_fwd_bwd})},
    }


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    os_err, os_sum_rel_err, os_cases = check_order_stat(gen)
    mm_err, mm_cases = check_matmul(gen)
    fused_errs, da_rel, fused_cases = check_fused(gen)
    bos_err, bos_sum_rel, bos_rows = check_batched_order_stat(gen)
    attn_errs, attn_cases = check_attention(gen)
    packed_errs, packed_cases = check_packed_kernels(gen)
    timings = {
        "order_stat": [time_order_stat(gen, n) for n in OS_SIZES[:2]],
        "ternary_matmul": [time_matmul(gen, MAX_BATCH, n, k)
                           for n, k in MM_SHAPES[:2]]
        + [time_matmul(gen, 1, n, k) for n, k in MM_SHAPES[:2]]
        # the shape that routes to _kernel_kblocked in JAX
        + [time_matmul(gen, 128, 128, 8704)],
    }
    for shape in FUSED_SHAPES[:2]:  # the recipe's two head layers
        for name, t in time_fused(gen, *shape).items():
            timings.setdefault(name, []).append(t)
    timings["batched_order_stat"] = [time_batched_order_stat(gen, *shape)
                                     for shape in BATCHED_OS_SHAPES[:2]]
    for name, t in time_attention(gen).items():
        timings[name] = [t]
    for shape in PACKED_SHAPES:
        for name, t in time_packed(gen, *shape).items():
            timings.setdefault(name, []).append(t)
    emit({"phase": "kernels", "order_stat_cases": os_cases,
          "order_stat_max_abs_err": os_err,  # statistic and max
          "order_stat_sum_max_rel_err": os_sum_rel_err,
          "ternary_matmul_cases": mm_cases,
          "ternary_matmul_max_abs_err": mm_err,
          "fused_cases": fused_cases, "fused_max_abs_err": fused_errs,
          "fused_dalpha_max_rel_err": da_rel,
          "batched_order_stat_rows": bos_rows,
          "batched_order_stat_max_abs_err": bos_err,  # statistic and max
          "batched_order_stat_sum_max_rel_err": bos_sum_rel,
          "attention_cases": attn_cases,
          "packed_cases": packed_cases,
          "packed_max_abs_err": packed_errs, "timings": timings})
    return {"order_stat": os_err, "ternary_matmul": mm_err,
            "batched_order_stat": bos_err, **fused_errs,
            **attn_errs, **packed_errs}, timings


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


def make_retrieval_checkpoint(tmpdir):
    """A seeded README-width retrieval model as a JAX-layout .npz, with a
    vocab.json beside it built from the synthetic corpus's training split.
    BatchNorm statistics are drawn and each ternary layer's alpha is set to
    its optimal alpha, as make_checkpoint does for the classifier."""
    from torch import nn

    from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
    from atq_tpu_torch.data.flickr8k import (
        _synthetic_corpus,
        save_vocab_file,
        synthetic_vocabulary,
    )
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.nn.layers import _QuantizedLinear
    from atq_tpu_torch.utils.jax_interop import save_checkpoint

    names, captions, latents = _synthetic_corpus(400)
    vocab = synthetic_vocabulary([c for n in names[:320]
                                  for c in captions[n]])
    gen = torch.Generator().manual_seed(0)
    model = ATQMultimodalRetrieval(vocab_size=len(vocab), embed_dim=192,
                                   hidden_dim=384, use_residual=True,
                                   max_seq_length=SEQ_LEN, device="cpu",
                                   generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(mod, _QuantizedLinear):
                _, a = adaptive_ternary_quantization(
                    mod.weight, sparsity_target=mod.sparsity_target)
                mod.alpha.fill_(float(a))
    path = os.path.join(tmpdir, "retrieval", "best_model.npz")
    os.makedirs(os.path.dirname(path))
    save_checkpoint(model.jax_variables(), path)
    save_vocab_file(vocab, os.path.join(os.path.dirname(path), "vocab.json"))
    return path, vocab, (names, captions, latents)


def retrieval_requests(vocab, corpus):
    """The phase's traffic: 32 images (160x160x3 in [0, 1], sent with
    ``normalize``), 32 captions (half sent as text, half as token ids), and
    16 search captions; with the arrays the CPU reference encodes."""
    import zlib

    from atq_tpu_torch.data.flickr8k import (
        END,
        IMAGENET_MEAN,
        IMAGENET_STD,
        START,
        UNK,
        _synthetic_image,
        clean_caption,
        tokenize,
    )

    names, captions, latents = corpus
    picked = names[:N_IMAGES]
    images = np.stack([_synthetic_image(
        latents[n], IMAGE_SIZE, seed=zlib.crc32(n.encode()) % 2 ** 31)
        for n in picked])

    def ids_of(text):
        toks = tokenize(clean_caption(text))
        return ([START] + [vocab.get(t, UNK) for t in toks] + [END])[:SEQ_LEN]

    texts = [captions[n][0] for n in picked[:N_TEXTS]]
    queries = [captions[n][1] for n in picked[:N_SEARCHES]]
    text_payloads = [{"text": t} if i % 2 == 0 else {"tokens": ids_of(t)}
                     for i, t in enumerate(texts)]
    tokens = np.zeros((N_TEXTS + N_SEARCHES, SEQ_LEN), np.int64)
    lengths = np.zeros((N_TEXTS + N_SEARCHES,), np.int64)
    for i, t in enumerate(texts + queries):
        ids = ids_of(t)
        tokens[i, :len(ids)], lengths[i] = ids, len(ids)
    return {"images": images,
            "normalized": (images - IMAGENET_MEAN) / IMAGENET_STD,
            "text_payloads": text_payloads, "queries": queries,
            "tokens": tokens, "lengths": lengths}


def _retrieval_args(path, *extra):
    from atq_tpu_torch.serve.__main__ import build_parser

    return build_parser().parse_args(
        [a for a in RETRIEVAL_ARGV if a != "--packed"]
        + ["--checkpoint", path, *extra])


def retrieval_cpu_reference(path, vocab, req):
    """The packed, int8-trunk model on the CPU (plain versions): each image
    embedded alone (the int8 trunk's activation scale is one per batch, as
    in JAX, so an image's embedding depends on its batch), the 32 images as
    one batch, the 32 texts and 16 queries, and the top-1 ids of the 16
    searches with their top-2 gaps over the 64 items the phase adds."""
    from atq_tpu_torch.serve.__main__ import build_retrieval
    from atq_tpu_torch.serve.index import EmbeddingIndex
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    model = build_retrieval(_retrieval_args(path, "--packed"),
                            load_checkpoint(path), "parity",
                            torch.device("cpu"), len(vocab))
    x = torch.from_numpy(req["normalized"])
    with torch.inference_mode():
        img = torch.cat([model.encode_image(x[i:i + 1])
                         for i in range(len(x))]).numpy()
        img_batch = model.encode_image(x).numpy()
        txt = model.encode_text(torch.from_numpy(req["tokens"]),
                                torch.from_numpy(req["lengths"])).numpy()
    index = EmbeddingIndex(192, device="cpu")
    index.add([f"img{i}" for i in range(N_IMAGES)], img)
    index.add([f"txt{i}" for i in range(N_TEXTS)], txt[:N_TEXTS])
    ids, scores = index.search(txt[N_TEXTS:], k=2)
    return {"image": img, "image_batch": img_batch, "text": txt[:N_TEXTS],
            "query": txt[N_TEXTS:],
            "top1": [row[0] for row in ids],
            "gap": (scores[:, 0] - scores[:, 1]).tolist()}


def _post_json(port, route, payload):
    """The route's answer and its latency (ms); an HTTP error raises with
    the server's error message."""
    body = json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", body,
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{route}: HTTP {e.code} {e.read()!r}") from e
    return out, (time.perf_counter() - t0) * 1e3


def _retrieval_burst(port, req):
    """The 32 image and 32 text embeds at once, one client thread each."""
    calls = ([("/embed_image", _image_payload(im)) for im in req["images"]]
             + [("/embed_text", p) for p in req["text_payloads"]])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(calls)) as pool:
        answers = list(pool.map(lambda c: _post_json(port, *c), calls))
    wall = time.perf_counter() - t0
    emb = np.asarray([a["embedding"] for a, _ in answers], np.float32)
    return emb[:N_IMAGES], emb[N_IMAGES:], [t for _, t in answers], wall


def _image_payload(im):
    return {"image": im.tolist(), "normalize": True}


def _sequential_images(port, req, route="/embed_image"):
    """Each image posted alone (a batch of one): the answers of
    /embed_image, or the counts of /index/add."""
    out = []
    for i, im in enumerate(req["images"]):
        payload = _image_payload(im)
        if route == "/index/add":
            payload["id"] = f"img{i}"
        out.append(_post_json(port, route, payload)[0])
    return out


def _index_and_search(port, req):
    """64 /index/add (the 32 images one at a time, so that their embeddings
    are those of a batch of one; the 32 texts at once), then 16 concurrent
    /search; returns the searches' answers."""
    counts = [a["count"] for a in _sequential_images(port, req, "/index/add")]
    adds = [{"id": f"txt{i}", **p} for i, p in enumerate(req["text_payloads"])]
    with ThreadPoolExecutor(len(adds)) as pool:
        counts += [a["count"] for a, _ in pool.map(
            lambda p: _post_json(port, "/index/add", p), adds)]
    if max(counts) != N_IMAGES + N_TEXTS:
        raise AssertionError(f"/index/add counts {sorted(counts)}")
    with ThreadPoolExecutor(N_SEARCHES) as pool:
        return [a for a, _ in pool.map(
            lambda q: _post_json(port, "/search", {"text": q, "k": 2}),
            req["queries"])]


def phase_serve_retrieval(name, path, req, ref, pack32=False, same_as=None):
    """The port's retrieval server in-process (README widths, int8 trunk,
    --packed; planar32 words under ``pack32``): a warm-up request, the 32
    images one at a time, the burst, a traced burst, 64 /index/add and 16
    /search. The images sent alone and the burst's texts are checked
    against the CPU plain path, the burst's images against the images sent
    alone by cosine (their batch sets the int8 activation scale, and the
    burst's batches do not repeat), and, with ``same_as`` (another phase's
    images sent alone and texts), against those within 1e-5. After the
    served run, the model is built on the card as the server builds it and
    the 32 images go through it as one batch, checked against the same
    batch on the CPU plain path."""
    from torch.profiler import ProfilerActivity, profile

    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.__main__ import build_retrieval, build_server
    from atq_tpu_torch.serve.http import start_in_thread
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    t0 = time.perf_counter()
    os.environ["ATQ_PACK32"] = "1" if pack32 else "0"
    try:  # ATQ_PACK32 is read at export time
        httpd, servers, info = build_server(
            RETRIEVAL_ARGV + ["--checkpoint", path, "--port", "0",
                              "--max_batch", str(MAX_BATCH)])
        model = build_retrieval(_retrieval_args(path, "--packed"),
                                load_checkpoint(path), "parity",
                                torch.device("cuda"), len(load_vocab(path)))
    finally:
        os.environ["ATQ_PACK32"] = "0"
    thread = start_in_thread(httpd)
    _reset_launches()
    try:
        _post_json(info["port"], "/embed_image",
                   _image_payload(req["images"][0]))
        img = np.asarray([a["embedding"] for a in _sequential_images(
            info["port"], req)], np.float32)
        burst_img, txt, lat, wall = _retrieval_burst(info["port"], req)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, _, traced_wall = _retrieval_burst(info["port"], req)
            torch.cuda.synchronize()
        searches = _index_and_search(info["port"], req)
        stats = [dict(s.stats) for s in servers]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        for s in servers:
            s.stop()
    launches = kernel_launches()
    busy_s = _device_us(prof.key_averages()) / 1e6
    with torch.inference_mode():
        img_batch = model.encode_image(
            torch.from_numpy(req["normalized"]).cuda()).cpu().numpy()

    for what, got, want in (("image", img, ref["image"]),
                            ("image_batch", img_batch, ref["image_batch"]),
                            ("text", txt, ref["text"])):
        if not np.isfinite(got).all() or got.shape != want.shape:
            raise AssertionError(f"{name}: bad {what} embeddings "
                                 f"{got.shape}")
        np.testing.assert_allclose(got, want, rtol=0, atol=RETRIEVAL_ATOL,
                                   err_msg=f"{name} {what} vs CPU")
    cosine = np.sum(burst_img * img, axis=1)  # unit-norm rows
    if not np.isfinite(burst_img).all() or cosine.min() < BURST_MIN_COSINE:
        raise AssertionError(f"{name}: burst images vs alone, cosine "
                             f"{cosine.min()}")
    same = {}
    if same_as is not None:
        for what, got, other in (("image", img, same_as[0]),
                                 ("text", txt, same_as[1])):
            np.testing.assert_allclose(got, other, rtol=0, atol=1e-5,
                                       err_msg=f"{name} {what} vs uint8")
            same[what] = float(np.abs(got - other).max())
    top1 = [s["results"][0]["id"] for s in searches]
    agree = [g == w for g, w, gap in zip(top1, ref["top1"], ref["gap"])
             if gap > 1e-3]
    if not all(agree):
        raise AssertionError(f"{name}: /search top-1 {top1} vs CPU "
                             f"{ref['top1']} (gaps {ref['gap']})")
    kernel = "ternary_matmul32" if pack32 else "ternary_matmul"
    img_batches, txt_batches = stats[0]["batches"], stats[1]["batches"]
    want_launches = IMAGE_LAUNCHES * img_batches + TEXT_LAUNCHES * txt_batches
    if launches[kernel] != want_launches:
        raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} "
                             f"times for {img_batches} image and "
                             f"{txt_batches} text batches, expected "
                             f"{want_launches}")
    if any(s["primary_failures"] or s["fallback_batches"] for s in stats):
        raise AssertionError(f"{name}: engine failures {stats}")
    lat = np.asarray(lat)
    emit({"phase": name, "requests": N_IMAGES + N_TEXTS, "failed": 0,
          "wall_s": wall, "requests_per_s": (N_IMAGES + N_TEXTS) / wall,
          "p50_ms": float(np.percentile(lat, 50)),
          "p99_ms": float(np.percentile(lat, 99)),
          "batches": {"image": img_batches, "text": txt_batches},
          "requests_served": {"image": stats[0]["requests"],
                              "text": stats[1]["requests"]},
          "launches": launches, "traced_wall_s": traced_wall,
          "device_busy_share": (busy_s / traced_wall if busy_s else None),
          "max_abs_err_vs_cpu": {
              "image": float(np.abs(img - ref["image"]).max()),
              "image_batch": float(np.abs(img_batch
                                          - ref["image_batch"]).max()),
              "text": float(np.abs(txt - ref["text"]).max())},
          "burst_image_vs_alone": {
              "min_cosine": float(cosine.min()),
              "max_abs_diff": float(np.abs(burst_img - img).max())},
          "search_top1_checked": len(agree),
          **({"max_abs_diff_vs_uint8_planes": same} if same else {}),
          "seconds": time.perf_counter() - t0})
    return img, txt, launches


def phase_dense_correction(path, req, ref, clf_path, images, clf_sparse):
    """The classifier and the retrieval encoders exported with
    ``sparse_correction=False``: every RPB layer through kernel 4, checked
    against the sparse export on the card (1e-4) and the CPU plain path
    (the images alone and as one batch of 32, the texts)."""
    from atq_tpu_torch.data.mnist import FASHION_STATS
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.__main__ import (
        build_classifier,
        build_parser,
        build_retrieval,
    )
    from atq_tpu_torch.serve.packed_model import (
        attach_packed_collection,
        export_packed_collection,
    )
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    ckpt = load_checkpoint(path)
    model = build_retrieval(_retrieval_args(path), ckpt, "parity", dev,
                            len(load_vocab(path)))
    params = {k: v for k, v in ckpt["params"].items() if k != "fusion"}
    attach_packed_collection(model, export_packed_collection(
        params, ckpt.get("quant"), device=dev, sparse_correction=False))
    clf_ckpt = load_checkpoint(clf_path)
    clf = build_classifier(build_parser().parse_args(
        ["--task", "classification", "--checkpoint", clf_path,
         "--use-rpb"]), clf_ckpt, "parity", dev)
    attach_packed_collection(clf, export_packed_collection(
        clf_ckpt["params"], clf_ckpt.get("quant"), device=dev,
        sparse_correction=False))
    mean, std = FASHION_STATS
    x_clf = torch.from_numpy(((images - mean) / std)[..., None]).to(dev)
    _reset_launches()
    x_img = torch.from_numpy(req["normalized"]).to(dev)
    with torch.inference_mode():  # images alone, as the sparse phase sent them
        img = torch.cat([model.encode_image(x_img[i:i + 1])
                         for i in range(N_IMAGES)]).cpu().numpy()
        img_batch = model.encode_image(x_img).cpu().numpy()
        txt = model.encode_text(
            torch.from_numpy(req["tokens"][:N_TEXTS]).to(dev),
            torch.from_numpy(req["lengths"][:N_TEXTS]).to(dev)).cpu().numpy()
        logits = torch.cat([clf(x_clf[i:i + MAX_BATCH]) for i in range(
            0, len(images), MAX_BATCH)]).cpu().numpy()
    torch.cuda.synchronize()
    launches = kernel_launches()
    errs = {}
    for what, got, sparse, cpu in (
            ("image", img, ref["sparse_image"], ref["image"]),
            ("image_batch", img_batch, None, ref["image_batch"]),
            ("text", txt, ref["sparse_text"], ref["text"]),
            ("logits", logits, clf_sparse, None)):
        if sparse is not None:
            np.testing.assert_allclose(got, sparse, rtol=0, atol=1e-4,
                                       err_msg=f"dense correction {what} vs "
                                               f"the sparse export")
            errs[what + "_vs_sparse"] = float(np.abs(got - sparse).max())
        if cpu is not None:
            np.testing.assert_allclose(got, cpu, rtol=0,
                                       atol=RETRIEVAL_ATOL,
                                       err_msg=f"dense correction {what} "
                                               f"vs CPU")
            errs[what + "_vs_cpu"] = float(np.abs(got - cpu).max())
    batches = -(-len(images) // MAX_BATCH)
    want = IMAGE_LAUNCHES * (N_IMAGES + 1) + TEXT_LAUNCHES + 2 * batches
    if launches["ternary_matmul_rpb"] != want or launches["ternary_matmul"]:
        raise AssertionError(f"serve_dense_correction launches {launches}, "
                             f"expected {want} of ternary_matmul_rpb")
    emit({"phase": "serve_dense_correction", "launches": launches,
          "batches": {"image": N_IMAGES + 1, "text": 1,
                      "classifier": batches},
          "max_abs_err": errs, "seconds": time.perf_counter() - t0})
    return launches


def load_vocab(path):
    from atq_tpu_torch.data.flickr8k import load_vocab_file

    return load_vocab_file(os.path.join(os.path.dirname(path), "vocab.json"))


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


def _calibrate_alphas(model):
    """Set each ternary layer's alpha to its optimal alpha, as a trained
    checkpoint holds it, computed on the CPU from the (identical) weights so
    both devices get the same values. At the harness's alpha = 1 init the
    projections reach |q| ~ 100 and the softmax is all but an argmax, where
    rounding differences of 1e-7 in the scores move the gradients by
    percents of the largest, card against CPU, on the einsum path as on
    the fused one."""
    from atq_tpu_torch.core.quantize import (
        adaptive_ternary_quantization_batched,
    )

    stack = model.layers.scan.layer
    with torch.no_grad():
        for mod in stack.modules():
            if hasattr(mod, "alpha") and hasattr(mod, "precision_mask"):
                _, a = adaptive_ternary_quantization_batched(
                    mod.weight.cpu(), sparsity_target=mod.sparsity_target.cpu())
                mod.alpha.copy_(a.reshape(mod.alpha.shape))


def _encoder_step0(device, use_amp, attn, hoist):
    """Loss and every gradient of step 0 of the port's QAT step at
    ENCODER_STEP0 on ``device``, from the seed-0 init with calibrated
    alphas."""
    from atq_tpu_torch.train.scale import build_step

    step, _, state, _ = build_step(*ENCODER_STEP0, use_amp=use_amp,
                                   attn_impl=attn, hoist_quant=hoist,
                                   device=device)
    _calibrate_alphas(state[0])
    state, loss = step(state)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu() for n, p in state[0].named_parameters()}
    return float(loss), grads


def _compare_encoder(what, got, want, loss_rtol, rtol, atol):
    """Raises past the tolerances (atol relative to the largest
    |gradient|); returns the largest differences."""
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    if loss_rel > loss_rtol:
        raise AssertionError(f"{what}: loss {got[0]} vs {want[0]}")
    top = max(g.abs().max().item() for g in want[1].values())
    worst, worst_name = 0.0, None
    for name, g in want[1].items():
        torch.testing.assert_close(got[1][name], g, rtol=rtol, atol=atol * top,
                                   msg=lambda m: f"{what} grad {name}: {m}")
        err = (got[1][name] - g).abs().max().item() / top
        if err > worst:
            worst, worst_name = err, name
    return {"loss": [got[0], want[0]], "loss_rel_diff": loss_rel,
            "grad_max_abs_diff_over_max": worst, "worst_leaf": worst_name,
            "grad_max": top, "grad_leaves": len(want[1])}


def phase_encoder_step0():
    """Step 0 at bert-base widths (2 layers, batch 8, sequence 256):
    fused+hoisted on the card against the CPU's plain versions in float32,
    then fused+hoisted against einsum+unhoisted on the card under AMP."""
    from atq_tpu_torch.ops import kernel_launches

    t0 = time.perf_counter()
    cpu = _encoder_step0("cpu", False, "fused", True)
    _reset_launches()
    card = _encoder_step0("cuda", False, "fused", True)
    launches = kernel_launches()
    for k in ENCODER_PER_STEP:
        if not launches[k]:
            raise AssertionError(f"encoder step 0: {k} never launched")
    f32 = _compare_encoder("encoder step 0 card vs cpu", card, cpu,
                           STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL)
    amp_fused = _encoder_step0("cuda", True, "fused", True)
    amp_einsum = _encoder_step0("cuda", True, "einsum", False)
    amp = _compare_encoder("encoder step 0 fused+hoist vs einsum (AMP)",
                           amp_fused, amp_einsum, AMP_LOSS_RTOL,
                           AMP_GRAD_RTOL, AMP_GRAD_ATOL)
    emit({"phase": "encoder_step0", "config": ENCODER_STEP0,
          "card_vs_cpu_f32": f32, "fused_hoist_vs_einsum_amp": amp,
          "launches_card_f32": launches,
          "seconds": time.perf_counter() - t0})


def _trace_encoder():
    """Device busy share and top kernels over two traced steps of the
    bert-base run, after two untraced ones."""
    from torch.profiler import ProfilerActivity, profile

    from atq_tpu_torch.train.scale import CONFIGS, build_step

    t0 = time.perf_counter()
    step, _, state, _ = build_step(*CONFIGS["bert-base"], use_amp=True,
                                   attn_impl="fused", hoist_quant=True,
                                   device="cuda")
    build_s = time.perf_counter() - t0
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    events = prof.key_averages()
    busy_s = _device_us(events) / 1e6
    return {"build_s": build_s, "traced_steps": steps, "wall_s": wall,
            "busy_share": busy_s / wall, **_breakdown(events, steps, top=12)}


def phase_train_encoder(tmp):
    """``python -m atq_tpu_torch.train.scale --configs bert-base --attn
    fused --hoist``'s main() at full width and depth, counts reset before
    it and read after it; then a traced pair of steps."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.scale import main as scale_main

    out = os.path.join(tmp, "scale.json")
    _reset_launches()
    t0 = time.perf_counter()
    rows = scale_main(ENCODER_ARGV + ["--out", out])
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    row = rows[0]
    if "error" in row:
        raise AssertionError(f"train_encoder: {row['error']}")
    losses = row["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"train_encoder: losses {losses}")
    per_step = row["launches_per_step"]
    for k, want in ENCODER_PER_STEP.items():
        if per_step[k] != want:
            raise AssertionError(f"train_encoder: {k} {per_step[k]} per "
                                 f"step, expected {want}")
    trace = _trace_encoder()
    emit({"phase": "train_encoder", "argv": ENCODER_ARGV, "wall_s": wall,
          **{k: row[k] for k in ("ms_per_step", "tokens_per_sec", "mfu_pct",
                                 "peak_memory_gib", "params_millions",
                                 "flops_per_step", "losses",
                                 "launches_per_step", "device")},
          "launches": launches, "trace": trace})
    return launches


# --compare: the packed kernels at serving's head shapes (M = 32 and 1),
# the K-blocked shape and PACKED_SHAPES, old against new.
COMPARE_MM = tuple((m, n, k) for m in (MAX_BATCH, 1) for n, k in MM_SHAPES) \
    + ((128, 128, 8704),)
PACKED_KERNELS = ("ternary_matmul", "ternary_matmul32", "ternary_matmul_rpb")


def time_tree(tree, out):
    """Times the packed kernels with ``tree``'s own chip_smoke.py and
    atq_tpu_torch (which build that tree's kernels) at COMPARE_MM
    (time_matmul) and PACKED_SHAPES (time_packed); writes them to ``out``."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    mod = importlib.import_module("chip_smoke")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"tree": tree,
              "matmul": [mod.time_matmul(gen, *s) for s in COMPARE_MM],
              "packed": [mod.time_packed(gen, *s) for s in PACKED_SHAPES]}
    with open(out, "w") as f:
        json.dump(result, f)


def compare(parent, out_dir="outputs/compare"):
    """The packed kernels of ``parent`` (another checkout) and of this tree
    on one card, in turns parent, this, this, parent, each in a process of
    its own; device ms (torch.profiler) at every shape, and summed per
    batch on each main path. Each run's rows go to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, tree in enumerate((parent, ".", ".", parent)):
        path = os.path.abspath(os.path.join(out_dir, f"compare_{i}.json"))
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-tree", tree, path], check=True, timeout=900)
        with open(path) as f:
            runs.append(json.load(f))
    old, new = (runs[0], runs[3]), (runs[1], runs[2])

    def pick(pair, what, i, name):
        rows = [r[what][i] if name is None else r[what][i][name]
                for r in pair]
        return rows, float(np.mean([r["kernel_device_ms"] for r in rows
                                    if r["kernel_device_ms"] is not None]))

    ms = {}
    cases = [("matmul", i, None, "ternary_matmul", (m, k, n))
             for i, (m, n, k) in enumerate(COMPARE_MM)]
    cases += [("packed", i, name, name, shape)
              for i, shape in enumerate(PACKED_SHAPES)
              for name in PACKED_KERNELS]
    for what, i, key, name, (m, k, n) in cases:
        old_rows, old_ms = pick(old, what, i, key)
        new_rows, new_ms = pick(new, what, i, key)
        ms[name, m, k, n] = (old_ms, new_ms)
        emit({"compare": name, "m": m, "k": k, "n": n, "old_ms": old_ms,
              "new_ms": new_ms, "new_over_old": new_ms / old_ms,
              "old_runs": [r["kernel_device_ms"] for r in old_rows],
              "new_runs": [r["kernel_device_ms"] for r in new_rows],
              "library_ms": float(np.mean([r["library_device_ms"]
                                           for r in new_rows])),
              "bound_ms": new_rows[0]["bound_ms"],
              "bound_by": new_rows[0]["bound_by"]})
    # Per batch: serve_packed's head at M = 32; a text batch's 24 layer
    # projections and attention_pool_0 at M = 1600; an image batch's
    # projector.
    text = ((16, 192, 192), (4, 192, 384), (4, 384, 192), (1, 192, 96))
    per_batch = {"serve_packed": [sum(ms["ternary_matmul", MAX_BATCH, k, n][j]
                                      for n, k in MM_SHAPES[:2])
                                  for j in (0, 1)]}
    for name in PACKED_KERNELS:
        per_batch[f"text_batch_{name}"] = [
            sum(c * ms[name, 1600, k, n][j] for c, k, n in text)
            for j in (0, 1)]
        per_batch[f"image_batch_{name}"] = list(ms[name, 32, 512, 192])
    emit({"per_batch_device_ms_old_new": per_batch})


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--time-tree"]:
        time_tree(*argv[1:3])
        return 0
    if argv[:1] == ["--compare"]:
        compare(*argv[1:3])
        return 0
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
        t0 = time.perf_counter()
        ret_path, vocab, corpus = make_retrieval_checkpoint(tmp)
        req = retrieval_requests(vocab, corpus)
        ret_ref = retrieval_cpu_reference(ret_path, vocab, req)
        emit({"phase": "retrieval_cpu_reference",
              "seconds": time.perf_counter() - t0})
        img, txt, _ = phase_serve_retrieval("serve_retrieval", ret_path,
                                            req, ret_ref)
        _, _, pack32_launches = phase_serve_retrieval(
            "serve_retrieval_pack32", ret_path, req, ret_ref, pack32=True,
            same_as=(img, txt))
        rpb_launches = phase_dense_correction(
            ret_path, req, {**ret_ref, "sparse_image": img,
                            "sparse_text": txt}, path, images, packed)
        batch = _step0_batch()
        cpu_step0 = _step0("cpu", False, batch)
        _, dense_step0 = phase_train("train_dense", False, tmp, batch,
                                     cpu_step0)
        fused_launches, _ = phase_train("train_fused", True, tmp, batch,
                                        dense_step0)
        phase_encoder_step0()
        encoder_launches = phase_train_encoder(tmp)

    sources = {
        "order_stat": ("atq_tpu_torch/csrc/order_stat.cu",
                       "atq_tpu/ops/order_stat.py:44 (_kernel)",
                       dense_launches["order_stat"]),
        "ternary_matmul": ("atq_tpu_torch/csrc/ternary_matmul.cu",
                           "atq_tpu/ops/ternary_matmul.py:85 (_kernel), "
                           ":207 (_kernel_kblocked)",
                           packed_launches["ternary_matmul"]),
        "ternary_matmul_rpb": ("atq_tpu_torch/csrc/ternary_matmul.cu",
                               "atq_tpu/ops/ternary_matmul.py:106 "
                               "(_kernel_rpb)",
                               rpb_launches["ternary_matmul_rpb"]),
        "ternary_matmul32": ("atq_tpu_torch/csrc/ternary_matmul.cu",
                             "atq_tpu/ops/ternary_matmul.py:362 (_kernel32)",
                             pack32_launches["ternary_matmul32"]),
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
        "batched_order_stat": ("atq_tpu_torch/csrc/order_stat.cu",
                               "atq_tpu/ops/order_stat.py:138 "
                               "(_batched_kernel)",
                               encoder_launches["batched_order_stat"]),
        "fused_attention_fwd": ("atq_tpu_torch/csrc/fused_attention.cu",
                                "atq_tpu/ops/fused_attention.py:49 "
                                "(_fwd_kernel)",
                                encoder_launches["fused_attention_fwd"]),
        "fused_attention_bwd": ("atq_tpu_torch/csrc/fused_attention.cu",
                                "atq_tpu/ops/fused_attention.py:72 "
                                "(_bwd_kernel)",
                                encoder_launches["fused_attention_bwd"]),
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
