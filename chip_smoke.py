#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``atq_tpu_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with
                                   # one NVIDIA H100 (sm_90a) and nvcc
    python3 chip_smoke.py --compare DIR [OUT [KIND ...]]
                                   # the packed, fused and attention kernels
                                   # and both order statistics of another
                                   # checkout (DIR) against this tree's, in
                                   # turns DIR, this, this, DIR (device ms;
                                   # raw rows in OUT, default
                                   # outputs/compare; KIND as below)
    python3 chip_smoke.py --time-tree DIR OUT [KIND ...]
                                   # one tree's kernel times into OUT;
                                   # KIND (matmul, packed, fused,
                                   # attention, order_stat) limits them;
                                   # KIND encoder, only when named, also
                                   # runs train_encoder's step (ms/step,
                                   # tokens/s, MFU; attention device ms
                                   # of a traced step)
    python3 chip_smoke.py --encoder-step0 OUT [DIR]
                                   # the readings behind encoder_step0's
                                   # limits at seeds 0-2 (fused as shipped,
                                   # the forward swapped for its plain
                                   # version, for float64 and for two
                                   # planted faults) from DIR's package
                                   # (this tree by default)
    python3 chip_smoke.py --retrieval-step0 [OUT]
                                   # the readings behind train_retrieval's
                                   # step-0 limits (alpha 1 and optimal
                                   # alphas; card, CPU at 8 and 1 threads,
                                   # float64, planted faults), JSON in OUT
    python3 chip_smoke.py --retrieval-amp-step0 [OUT]
                                   # the readings behind
                                   # train_retrieval_amp's AMP limits (the
                                   # train step and eval mode; card twice,
                                   # CPU at 8 and 1 threads, planted
                                   # faults), JSON in OUT
    python3 chip_smoke.py --traced-aot SPEC
                                   # serve_aot's traced windows (a JSON
                                   # SPEC of artifacts in, counts out),
                                   # which serve_aot runs as a process of
                                   # its own
    python3 chip_smoke.py --amp-modules [OUT]
                                   # the readings behind
                                   # train_retrieval_amp's module limits
                                   # (text tower, fusion, projectors) at
                                   # seeds 0-2: card twice, CPU at 1
                                   # thread, planted faults; JSON in OUT
    python3 chip_smoke.py --retrieval-scan-step0 [OUT]
                                   # the readings behind
                                   # train_retrieval_scan's step-0 limits
                                   # (unrolled twice, scanned, planted
                                   # fault; dense and fused), JSON in OUT
    python3 chip_smoke.py --scale-out
                                   # the build and phase scale_out alone
                                   # on every card of the machine
    (--scale-out-checks and --scale-out-runs are the torchrun ranks that
    phase scale_out starts)

Phases, one JSON line each; any failure exits non-zero:

  build         compiles the CUDA kernels from atq_tpu_torch/csrc (nvcc);
                ptxas's registers and spills by kernel, and
                the HMMA count of each tiled_packed_kernel,
                gemm_tc_kernel, dwda_kernel and attention forward and
                backward (attn_fwd_kernel, attn_bwd_rows_kernel,
                attn_bwd_keys_kernel) instantiation (cuobjdump -sass).
  kernels       holds each kernel against its plain PyTorch version on the
                card (order statistic bit-exact at every listed size and
                rank, repeated bit for bit, one stream operation a call at
                every main-path shape; packed matmul within rtol 1e-5 /
                atol 5e-3, the JAX package's own kernel tolerance) and
                times kernel, plain
                version and a one-call PyTorch yardstick at the serving
                shapes, beside the card's bound for the same work (the
                packed kernels: bytes, or three bf16 passes a product at
                the tensor-core rate; the fused linear kernels and the
                attention forward and backward: bytes, or three TF32
                products a product at the TF32 rate; the others: bytes or
                f32 operations). First, what a registered op adds on the
                host (op_dispatch_us): the order statistic, the fused
                forward and the packed matmul called through
                torch.ops.atq_tpu_torch against their CUDA implementations
                called directly, 7 alternating windows of 200 calls each.
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
  packed_classifier
                serve.PackedClassifier (the classifier's deployment form:
                dense conv features, the head from 2-bit planes) on the
                card on serve_packed's checkpoint: one batch of 256
                synthetic Fashion-MNIST images (serve_packed's 64 first)
                within rtol/atol 1e-4 of the same class on the CPU and of
                serve_packed's /predict logits, 2 packed-kernel launches,
                and memory_footprint_bytes (equal on both devices).
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
  serve_aot     python -m atq_tpu_torch.serve --aot: the classifier
                --packed (serve_dense's checkpoint) and the retrieval
                model --packed --int8_trunk (serve_retrieval's),
                each run in processes of its own live, exporting and
                loading (seconds from process start to the first answer,
                equal answers, batch_polymorphic for all three programs);
                from the loaded artifacts, in a process of its own
                (--traced-aot, which also exports the dense predict
                program), the bursts traced
                (tiled_packed_kernel events = counted launches = packed
                layers x batches; a burst whose events differ from its
                launches is traced again, twice at most) and within the
                serving phases' limits of the CPU, and every program at
                batch 1 and 32 equal to
                the live model on the card bit for bit; a dense predict
                export's order_stat_cluster_kernel events = 2 calls
                (train_retrieval_amp's preemption drill runs beside that
                process; neither reads a time).
  train_dense   python -m atq_tpu_torch.train's own main() on the README
                recipe (--use-rpb --distill --use-l1 --clip-grad, batch
                256, --subset-fraction 0.25: 46 steps an epoch, 2 epochs,
                seed 0): imgs/s and step-time p50 per epoch, kernel
                launches per step (order statistic: 1); --profile-dir
                traces the first epoch and its validation, and the trace
                file read back gives, over the epoch's train_steps span,
                the device busy share and per step the host and device
                time and the top host ops by self time and device kernels,
                first/last step loss,
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
                rule), with one TF32 pass a product in the attention
                forward as a planted fault that must fail those limits;
                then, on the card under AMP, fused+hoisted against
                einsum+unhoisted: loss within 1e-4, gradients within rtol
                1e-3 and 1e-3 of the largest, the α leaves (one element a
                layer, which sums a whole layer's bf16 roundings) within
                1e-2 of the largest (AMP_ALPHA_ATOL), with the attention in
                bfloat16 as a planted fault that must fail them (it does at
                this seed, not at every seed). Under AMP no limit tells one
                TF32 pass from a correct forward: bf16 roundings of
                activations flip with the attention's last bits (PERF.md,
                PR 14). The float32 step's counted FLOPs (utils/flops.py
                counted_flops: FlopCounterMode and the kernels' own counts)
                on the card equal the CPU's.
  train_encoder that module's main() with --configs bert-base --attn fused
                --hoist (12 layers, batch 64, sequence 256, AMP, remat
                save_quantized, AdamW 1e-4): 2 warm-up and 8 timed steps on
                one batch; ms per step, tokens/s, MFU against the card's
                bf16 peak, the counted FLOPs of the first warm-up step
                (flops_per_step_counted, beside the analytic figure the MFU
                uses), peak memory, the losses (finite, the last below
                the first), launches per step (batched order statistic 6,
                attention forward 24 with remat's recompute, backward 12),
                then the device busy share, top kernels and the attention
                kernels' device ms of two traced steps.
  train_retrieval
                the retrieval slice (python -m atq_tpu_torch.train.retrieval)
                at the README recipe's widths. First the fused kernels at
                the step's shapes (RETRIEVAL_FUSED_SHAPES: the text tower's
                800 = 16 x 50 rows, 192 -> 384, 384 -> 192, 192 -> 192,
                192 -> 96, 96 -> 1, and the projectors' 16 rows), as in
                phase kernels. Then step 0 (dropout 0, float images, after
                --reinit_model and epoch 0's schedule, at optimal alphas;
                no update) on the card against the CPU, and with
                ATQ_FUSED=1 against dense on the card: loss within 1e-5
                relative, embeddings within 1e-5, every gradient leaf
                within RET_LEAF_TOL_CPU or RET_LEAF_TOL_FUSED of its own
                largest |gradient| (elementwise) and its own L2 norm,
                leaves zero to rounding aside (the comment above
                RET_LOSS_RTOL says why; --retrieval-step0 takes the
                readings behind the limits); launches a step:
                order statistic 27 (the path's layers with 16,384+
                weights), and fused
                forward, dx and dW/dalpha 28 each with ATQ_FUSED=1. Then
                the module's main() on the recipe (batch 16, 2 epochs of
                50 steps on a synthetic corpus of 200 images, --profile_dir
                tracing
                epoch 1 and its validation, the trace file read back over
                the epoch's train_steps span):
                pairs/s and step p50 per epoch, launches per step, host
                and device ms a traced step and the busy share, mean
                R@1/5/10 on validation and test (finite), the artifact
                files; then best_model.npz loaded into a fresh model must
                embed a validation batch within 1e-5 of the trainer's
                embedding function.
  evaluate      python -m atq_tpu_torch.evaluate's main() on the card on
                the trained checkpoints (train_dense's classifier,
                train_retrieval's best_model.npz), each command against
                itself with --device cpu: the classifier dense and
                --packed over the synthetic Fashion-MNIST test split
                (10,000 images; accuracy within the slack of images whose
                top-2 logits lie within twice serve_dense's tolerance,
                loss within rtol 1e-4), the README retrieval model
                --packed --int8_trunk --save_index over the synthetic
                corpus's test split (200 rows; each R@K within the slack
                of queries with another score within 2e-3 of their
                target's, the index's ids equal and its embeddings within
                1e-3, and its text embeddings computed again on the card
                and on the CPU at the evaluation's batch, within 1e-3:
                each R@K is reported beside its slack, which is wide);
                the card's index preloaded by serve --index_file,
                each of its 40 images its own /search top-1; launches
                equal to the batches' packed layers or order statistics.
                Then the text tower module by module, dense and --packed
                (a line a module: each module's output on the card in the
                card's forward and on the CPU's inputs against the CPU's,
                a packed layer's terms, each attention's largest score and
                its scores' distance; the summary names the module where
                the distance grows), the embedding within 1e-3.
  train_retrieval_scan
                --scan_layers at the recipe's widths. (a) Step 0
                (train_retrieval's set-up: dropout 0, optimal alphas) of
                the scanned model against the unrolled one on the same
                weights,
                dense and with ATQ_FUSED=1, each within train_retrieval's
                fused-vs-dense limits and also bit for bit but for
                ResNet-18's leaves (loss, embeddings, every other gradient;
                cuDNN's filter gradients do not repeat bit for bit: the
                comment above SCAN_LAYERS); under ATQ_FUSED=1
                every projection, stacked or not, runs the fused kernels.
                A planted fault (layers 1 and 2 of the stacked linear1
                weight swapped) must fail both; launches: order statistic
                27; fused forward 52 (the stacked layers' 24 again in
                their recompute), dx and dW/dalpha 28 each. (b) The recipe
                with --scan_layers
                --checkpoint_freq 1 for 2 epochs (losses finite, 27 order
                statistics a step), its orbax/step_2 removed, then epoch 2
                again with --resume --profile_dir: the trace file's top 10
                device ops (summarize_trace) and busy share, its
                order_stat_cluster_kernel events equal to the launches the
                trainer counted in the traced window, and those in its
                train_steps span to the epoch's steps' launches.
  train_retrieval_amp
                the trainer's --use_amp, GradCache and --resume at the
                recipe's widths. AMP step 0 (train_retrieval's set-up:
                dropout 0, optimal alphas, 16 float images) on the card
                against the CPU, in the train step and in eval mode
                (BatchNorm on its running statistics; the backward of
                <embeddings, fixed cotangents>), each held by the ratio
                sum|card - cpu_bf16| / sum|cpu_bf16 - cpu_f32| by leaf
                group and for the embeddings, and the loss: AMP_STEP_LIMIT
                and AMP_EVAL_LIMIT (the comment above them gives the
                readings, --retrieval-amp-step0 takes them). Planted
                faults (every BatchNorm in bf16; the convolutions left in
                float32) must fail the eval limits; no limit of the train
                step can tell them from a correct card (the CPU at 1
                thread against 8 reads as far as they do). Then the text
                tower, the fusion and the projectors each alone on the
                CPU's inputs in eval mode (outputs and the backward of
                fixed cotangents), held by the same ratio within
                AMP_MODULE_LIMIT, with those faults carried over (the
                module's products in float32, its LayerNorms in bf16),
                each of which must fail its module's limit. The train
                step's thresholds and ternary patterns under AMP equal
                float32's bit for bit (56 each), every threshold on a
                float32 weight; 27 order-statistic launches. Then GradCache
                at --batch_size 64 --grad_accum_steps 4 in float32 (dropout
                0.1, uint8 images): step 0 against the concatenated-pool
                oracle, and with ATQ_FUSED=1 against dense, every leaf
                within 1e-4 x (1 + its largest |gradient|), the loss within
                1e-5, running statistics and generator state equal to the
                oracle's; launches a step: order statistic 27 x 2 x 4
                (fused forward 28 x 8, dx and dW/dalpha 28 x 4); its peak
                memory above the resting allocation below the plain
                batch-64 step's (beside the plain batch-16 step's). Then the
                module's main() with --use_amp --batch_size 64
                --grad_accum_steps 4 for one epoch of 25 steps (counts reset
                before it and read after): pairs/s, step p50, launches,
                R@1/5/10 (finite); then 3 traced steps of that step on the
                trained model (after 2 untraced): host and device ms a step
                and the busy share. And the preemption drill (run in
                processes of its own beside serve_aot's loaded-artifact
                process, where no time is read; reported here): python -m
                atq_tpu_torch.train.retrieval on the recipe for 2 epochs
                of 25 steps (100 synthetic images) with --checkpoint_freq
                1, SIGKILLed as soon as it reports
                orbax/step_1 written, then rerun with --resume: exit 0,
                "Resumed from .../orbax at epoch 1", epoch 2 only, and the
                restored state's sha256 equal to the one the killed run
                saved.
  train_retrieval_moe
                the ternary-expert MoE FFN (--moe_experts 8) at the
                README's retrieval widths. Step 0 (train_retrieval's
                set-up: dropout 0, optimal alphas, 16 float images) on the
                card against the CPU: the loss (its 0.01 · aux term
                included) and embeddings, every gradient leaf at
                train_retrieval's card-vs-CPU limits (the expert planes,
                whose gradient is each expert's dα/nnz times its pattern,
                are among the leaves zero to rounding), each layer's aux loss
                within RET_LOSS_RTOL, the expert of every valid token (a
                token routed otherwise must have a gate-logit gap below
                MOE_GATE_GAP_RTOL of its largest |logit|; their count is
                printed), the experts' ternary patterns bit for bit, and
                the launches: 19 single and 8 batched order statistics
                (2 a layer: w1's and w2's stacks, (8, 73,728) each). Then
                one epoch of the module's main() with --moe_experts 8
                (counts reset before it and read after; the same launches
                a step; no CUDA tensor reaches the batched statistic's
                plain version): pairs/s, step p50, R@K finite. Then
                its final_model.npz (the epoch's weights) served through
                the serve CLI's retrieval
                routes with --moe_experts 8, dense and --packed, on the
                card against --device cpu (RETRIEVAL_ATOL), with the
                serving launches; and evaluated by python -m
                atq_tpu_torch.evaluate --moe_experts 8 on the card against
                --device cpu (R@K within the slack of near-tied scores,
                as phase evaluate holds it).
  resnet_rewrites
                ATQ_S2D_STEM=1 and ATQ_FAST_POOL=1 on ResNet-18 at 160x160
                (16 images) on the card: the eval features with both flags
                against the default path; the space-to-depth stem's output
                and gradients against the direct stem's; the stem pool's
                gradient on a tie-free input against PyTorch's max-pool
                backward, and on the stem's own post-ReLU map (ties at 0)
                against the port's plain version on the CPU, with its
                gradient sum kept. Each reading beside its limit
                (REWRITE_TOL); the whole network's gradients with the
                space-to-depth stem are printed, not held (the comment
                above REWRITE_TOL says why).

  scale_out     the multi-GPU scale-out on all N cards of the machine
                (torch.cuda.device_count()) in two torchrun launches.
                First the checks, over NCCL at world N, or at N = 1 over
                gloo at world 2 with both ranks on the one card (NCCL
                takes one rank a card): step 0 of the README recipe's
                widths at the global batch 16 a rank, dp over the world
                and the same with --fsdp (at N >= 4 also dp=N/2 x tp=2
                --fsdp and --moe_experts 8), against the one-GPU step on
                the same batch (the comment above SCALE_ENVELOPE has the
                limits), with a planted fault (every dα dropped) that must
                fail, 27 order statistics a step (the MoE: 19 and 8
                batched) and the per-rank state bytes; then the parallel
                library (LIBRARY_TOL): the negative pool's gather and its
                backward, moe_ffn_sharded (8 ternary experts, 8/world a
                rank, 2 batched order statistics), the row-sharded search
                (float32 and int8, ids equal), ring attention and the
                GPipe pipeline with their gradients, each against the
                one-process port on the same card (gloo carries the
                collectives of CUDA tensors but not their point-to-point
                sends, so over gloo the ring and the pipeline run on host
                tensors). Then, through torchrun --nproc_per_node N (one
                process a card, NCCL; at N = 1 world 1, where no process
                group starts, as JAX's init_distributed does nothing for
                one process), a short epoch of python -m
                atq_tpu_torch.train.retrieval's main() with --dp N, and
                --fsdp, dp=N/2 x tp=2 --fsdp and --moe_experts 8 where N
                allows (counts reset before each run in every rank and
                read after; pairs/s, the steady rate of the median step,
                the launches a step equal to step 0's), and the
                classifier's with --dp N (imgs/s).

The order statistic is held bit-exact (max equal, sum within 1e-6
relative) against the sort at OS_SIZES and RETRIEVAL_OS_SIZES (randn), at
401,408, 18,432 and 2,359,296 with duplicates, zeros, an all-equal row, a
row with over 90 % in one digit-0 bin and zeros and subnormals among
normals, and a sorted 2,359,296 (its held sample is not the row), at ranks
0, 1, 0.3n and n-1, each launched twice and repeated bit for bit. The
batched one likewise per row at (12, 589,824), (12, 2,359,296),
(3, 16,385), (1, 98,304), (13, 20,000) and the MoE expert stacks'
(8, 73,728), its first rows of those kinds,
with per-row ranks 0, n-1, 0.3n and 1. Both count the operations they put
on the stream a call (profiler: kernels and memsets) at every main-path
shape and fail unless it is 1. The attention kernels against their
plain versions at (64, 12, 256, 64) f32, (4, 4, 512, 64) f32,
(4, 4, 256, 64) bf16 and ATTN_CASES' edge cases (S = 1, 50, 64, 257, 512;
D = 16, 20, 64, 128; both dtypes; padding biases with a fully padded row):
o, dq, dk, dv within rtol/atol 1e-4 (f32) or 2e-2 (bf16), the forward and
the backward each launched twice and repeated bit for bit. The float32
forward's o is also held against a float64 forward: each element's error
over its Σ_j p_j·|v_j| within F64_REL_TOL (1e-5), which one TF32 pass a
product on the same inputs must miss. The attention rows of phase
kernels give the backward's device ms by launch (its two kernels) and the
kernels SDPA ran, by the profiler's names.

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
3136; the 3xTF32 products), dalpha within 1e-4 relative; also at
FUSED_EDGE_SHAPES (N = 10 and 24, K = 37, 99, 100 and 200, M = 1, 5, 7
and 17). Every kernel is launched twice a case and must repeat bit for
bit. y, dx and dW's G = gᵀx are also held against float64: the error over
the element's Σ|a|·|b| within F64_REL_TOL (1e-5), which one TF32 pass on
the same operands must miss at the two head layers.

--compare also holds the attention backward's bits equal in all four runs
(a digest of dq, dk, dv over ATTN_CASES; when attention is among its
kinds) and fails if they differ. With the kind encoder it gives each run's
train_encoder step: ms/step, tokens/s, MFU, and the attention kernels'
device ms in a traced pair of steps. Its order_stat rows give both wrappers'
device ms, event ms and stream operations a call at the main paths'
shapes.

Then one line {"kernels": [...]} (launch counts from the main-path phase
that runs each kernel: serve_dense, serve_packed, serve_retrieval_pack32,
serve_dense_correction, train_fused, train_encoder; train_retrieval and
train_retrieval_scan print their own on their lines; each kernel's
moe_launches are train_retrieval_moe's epoch, its scale_out_launches
scale_out's dp=N epoch on rank 0),
the card's name and power limit as nvidia-smi prints them, and the result
line {"ok": true, "device": {...}}. Without a GPU, or without the rest of
the repo beside it, the script exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

# NVIDIA H100 SXM published peaks (data sheet): HBM3 rate, the float32
# rate outside the tensor cores, and the dense bf16 and TF32 tensor-core
# rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
N_REQUESTS = 64
MAX_BATCH = 32
OS_SIZES = (401408, 802816, 16384, 16385, 2359296)
# The order statistic's main-path sizes past serve_dense's n = 401,408: the
# retrieval text tower's and projectors' layers of 16,384+ weights
# (train_retrieval: 192x96, 192x192, 192x384, 512x192).
RETRIEVAL_OS_SIZES = (18432, 36864, 73728, 98304)
MM_SHAPES = ((128, 3136), (10, 128), (256, 3136), (10, 256))
MM_RTOL, MM_ATOL = 1e-5, 5e-3
# Edge shapes of the packed kernels, (M, K, N): the eligibility minima
# (N = 8, K = 128), K = 200 (not a multiple of 16 or 32), M = 1 and 17.
EDGE_SHAPES = ((1, 128, 8), (17, 128, 8), (17, 200, 8), (1, 200, 24),
               (17, 200, 40))
FUSED_SHAPES = ((256, 128, 3136), (256, 10, 128), (256, 256, 3136),
                (7, 24, 100), (2304, 128, 3136))
FUSED_TOL = 1e-4  # rtol/atol on y, dx, dw; relative on dalpha
# y's, dx's and dW's G = gᵀx's largest error against a float64 product,
# over the element's Σ|a|·|b|: 3xTF32 with step sums sits near 1e-7 there,
# one TF32 pass near 1e-4 (tests/test_torch_fused_gemm_tc.py). dx's values
# are about 1e-3, so FUSED_TOL's atol alone would pass one TF32 pass; this
# bound does not. The attention forward's o is held the same way, each
# element's error over its Σ_j p_j·|v_j| (tests/test_torch_attention_fwd_
# tiled.py: 3xTF32 with step sums near 3e-7, one TF32 pass 5e-5 to 1e-3).
F64_REL_TOL = 1e-5
# Edge shapes of the dW/dalpha kernel, (M, N, K): N = 10 and 24, K = 100 and
# 200 (ragged 64 x 32 tiles, unaligned rows), M = 1, 7 and 17 (a partial
# step of its 32-row ring); M = 2304 is in FUSED_SHAPES.
DWDA_EDGE_SHAPES = ((1, 10, 100), (7, 24, 200), (17, 24, 100),
                    (17, 10, 200), (1, 24, 200))
# Edge shapes of all three fused kernels: DWDA_EDGE_SHAPES, then K = 99 and
# 37 (rows not 16-byte aligned: the forward's and dx's plain-load weight
# path, 4-byte copies of x) with N = 24 and 10 (g's rows: 4-byte copies).
FUSED_EDGE_SHAPES = DWDA_EDGE_SHAPES + ((17, 24, 99), (5, 10, 37))
STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# Batched order statistic: bert-base's two stacked weight shapes (q/k/v/out,
# linear1/linear2) and a ragged one.
BATCHED_OS_SHAPES = ((12, 589824), (12, 2359296), (3, 16385), (1, 98304),
                     (13, 20000), (8, 73728))
# The MoE FFN's expert stacks at the README widths: 8 experts of
# 192 x 384 (w1) or 384 x 192 (w2), at the text layers' sparsity 0.1.
MOE_OS_SHAPE = (8, 73728)
BERT_SPARSITY = 0.1  # the layers' initial sparsity, min(0.1, 0.3)
# Attention: bert-base's shape first (the main path's, f32 under AMP).
# Then the edge cases: S = 1, 50, 64, 257 and 512; D = 16, 20, 64 and 128;
# both dtypes; a padding bias with one fully padded batch row.
ATTN_CASES = (((64, 12, 256, 64), torch.float32, False),
              ((8, 8, 50, 16), torch.float32, True),
              ((4, 4, 512, 64), torch.float32, False),
              ((4, 4, 256, 64), torch.bfloat16, False),
              ((2, 3, 1, 16), torch.float32, False),
              ((2, 3, 1, 64), torch.bfloat16, True),
              ((4, 3, 50, 20), torch.float32, True),
              ((4, 3, 50, 20), torch.bfloat16, True),
              ((2, 2, 64, 128), torch.bfloat16, True),
              ((2, 4, 257, 64), torch.float32, True),
              ((1, 2, 257, 128), torch.bfloat16, False),
              ((2, 2, 512, 128), torch.float32, True),
              ((2, 2, 512, 16), torch.bfloat16, True))
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Encoder step 0: bert-base widths, 2 layers, batch 8, sequence 256.
ENCODER_STEP0 = (768, 3072, 12, 2, 256, 8, True, True)
AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_GRAD_ATOL = 1e-4, 1e-3, 1e-3
AMP_ALPHA_ATOL = 1e-2  # the α leaves' atol under AMP (phase_encoder_step0)
ENCODER_STEP0_SEEDS = (0, 1, 2)  # the seeds --encoder-step0 reads
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
    which the profiler records no device activity (it happens now and
    then), or a number of device events that is not a multiple of
    ``iters`` (some lost), is traced again, twice at most; then the last
    window with any activity counts, and None if none had any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    result = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total_us = _device_us(events)
        count = sum(e.count for e in events
                    if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            result = total_us / 1e3 / iters
            if count % iters == 0:
                return result
        print(f"device_ms: a window recorded {count} device events in "
              f"{iters} calls ({total_us} us); traced again",
              file=sys.stderr)
    return result


def device_ms_by_kernel(fn, iters=50):
    """Device ms per call of each kernel ``fn`` launches, by the
    profiler's kernel name; None if three traced windows record none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total / 1e3 / iters
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0}
        if rows:
            return rows
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
    seconds = time.perf_counter() - t0
    with open(build_info["library"][:-3] + ".log") as f:
        log = f.read()
    hmma = {kind: _sass_hmma(build_info["library"], kind)
            for kind in ("tiled_packed_kernel", "gemm_tc_kernel",
                         "dwda_kernel", "attn_fwd_kernel",
                         "attn_bwd_rows_kernel", "attn_bwd_keys_kernel")}
    for kind, counts in hmma.items():  # the tensor-core kernels use them
        if counts is not None and (not counts or 0 in counts.values()):
            raise AssertionError(f"{kind}: no HMMA in its SASS: {counts}")
    emit({"phase": "build", "seconds": seconds,
          "nvidia_smi": smi, "built": build_info["built"],
          "sources": build_info["sources"],
          "ptxas": _ptxas_by_kernel(log),
          **{f"{kind}_hmma": counts for kind, counts in hmma.items()}})


def _ptxas_by_kernel(log):
    """ptxas -v's spill and register lines, by entry function."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def _sass_hmma(library, kind):
    """HMMA instructions in the SASS (cuobjdump -sass) of each kernel
    instantiation whose name holds ``kind``, or None where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if kind not in name:
                name = None
            else:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def _os_row(kind, n, gen):
    """One non-negative float32 row of the order statistic's checks."""
    x = torch.randn(n, device="cuda", generator=gen).abs()
    u = torch.rand(n, device="cuda", generator=gen)
    if kind == "duplicates":
        return torch.randint(0, 8, (n,), device="cuda",
                             generator=gen).float() / 4
    if kind == "zeros":
        return torch.zeros(n, device="cuda")
    if kind == "equal":
        return torch.full((n,), 0.37, device="cuda")
    if kind == "bin90":  # > 90 % of the row in one digit-0 bin
        return torch.where(u < 0.05, x * 40, torch.full_like(x, 1.5))
    if kind == "subnormal":  # exact zeros and subnormals among normals
        return torch.where(u < 0.3, torch.zeros_like(x),
                           torch.where(u < 0.6, x * 1e-40, x))
    if kind == "sorted":  # a longer row's held sample is not the row
        return torch.sort(x).values
    return x


def _os_inputs(gen):
    for n in OS_SIZES + RETRIEVAL_OS_SIZES:
        yield "randn", n, _os_row("randn", n, gen)
    for n in (OS_SIZES[0], 18432, 2359296):
        for kind in ("duplicates", "zeros", "equal", "bin90", "subnormal"):
            yield kind, n, _os_row(kind, n, gen)
    yield "sorted", 2359296, _os_row("sorted", 2359296, gen)


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
            _same_bits(f"order_stat {kind} n={n} rank={r}",
                       lambda: torch.stack(
                           order_statistic_reductions(x, rank)), got)
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


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on finite float32 values (the kernels' rounding):
    10 mantissa bits kept, to nearest, ties away from zero."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _f64_rel_err(name, got, a, b, control):
    """got's largest error against the float64 product a·b, each element's
    over its Σ|a|·|b|; fails past F64_REL_TOL. With ``control``, one TF32
    pass on the same operands (rounded to TF32, summed exactly) must fail
    the bound, so that it tells 3xTF32 from one pass on this data. Returns
    both errors (the control's None without it)."""
    a64, b64 = a.double(), b.double()
    scale = a64.abs() @ b64.abs()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))

    def rel(out):
        return ((out.double() - a64 @ b64).abs() / scale).max().item()

    err = rel(got) if got.numel() else 0.0
    if err > F64_REL_TOL:
        raise AssertionError(f"{name}: {err} of Σ|a||b| from float64 "
                             f"(bound {F64_REL_TOL})")
    one = None
    if control:
        one = rel(_tf32_rna(a).double() @ _tf32_rna(b).double())
        if one <= F64_REL_TOL:
            raise AssertionError(f"{name}: one TF32 pass, {one}, meets the "
                                 f"bound {F64_REL_TOL}: it cannot tell")
    return err, one


def check_fused(gen, shapes=FUSED_SHAPES + FUSED_EDGE_SHAPES):
    """The three fused kernels against their plain versions at ``shapes``
    (FUSED_SHAPES and FUSED_EDGE_SHAPES unless given); every variant (mask
    or not; parity or STE for dW/dalpha). Each kernel is launched twice a case, and the
    two must agree bit for bit. The forward, dx and dW/dalpha's G = gᵀx
    (STE with an all-ones mask makes dw = G) also against float64
    (_f64_rel_err), with one TF32 pass as the control at the recipe's two
    head layers."""
    from atq_tpu_torch.ops import fused_linear as fl

    errs = {"fused_forward": 0.0, "fused_dx": 0.0, "fused_dwda": 0.0}
    # The kernels' largest error over Σ|a||b|, one TF32 pass's least.
    f64 = {name: {"kernel": 0.0, "one_tf32_pass": float("inf")}
           for name in errs}
    da_rel, cases = 0.0, 0
    for m, n, k in shapes:
        for with_mask in (True, False):
            x, w, g, mask, scal = _fused_inputs(gen, m, n, k, with_mask)
            tag = f"{m}x{n}x{k} mask={with_mask}"

            def forward():
                return fl.fused_linear_forward(x, w, mask, scal)

            def dx():
                return fl.fused_linear_dx(g, w, mask, scal)

            y, d = forward(), dx()
            _same_bits(f"forward {tag}", forward, y)
            _same_bits(f"dx {tag}", dx, d)
            errs["fused_forward"] = max(errs["fused_forward"], _err(
                f"forward {tag}", y, fl.forward_plain(x, w, mask, scal)))
            errs["fused_dx"] = max(errs["fused_dx"], _err(
                f"dx {tag}", d, fl.dx_plain(g, w, mask, scal)))
            w_eff = fl._w_eff(w, mask, scal[0], scal[1])[0]
            products = [("fused_forward", y, x, w_eff.T),
                        ("fused_dx", d, g, w_eff)]
            if with_mask:
                ones = torch.ones_like(mask)
                products.append(("fused_dwda", fl.fused_linear_dwda(
                    g, x, w, ones, scal, True)[0], g.T, x))
            for name, got, a, b in products:
                err, one = _f64_rel_err(f"{name} {tag}", got, a, b,
                                        (m, n, k) in FUSED_SHAPES[:2])
                f64[name]["kernel"] = max(f64[name]["kernel"], err)
                if one is not None:
                    f64[name]["one_tf32_pass"] = min(
                        f64[name]["one_tf32_pass"], one)
            for ste in (False, True):
                def dwda():
                    dw, da = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
                    return torch.cat([dw.flatten(), da.reshape(1)])

                both = dwda()
                _same_bits(f"dwda {tag} ste={ste}", dwda, both)
                dw, da = both[:-1].view(n, k), both[-1]
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
    return errs, f64, da_rel, cases


def time_fused(gen, m, n, k):
    """Kernel, plain version and the one-call cuBLAS yardstick on a
    prebuilt w_eff, for each of the three kernels, with the mask. Bounds:
    three TF32 products (3xTF32 on the tensor cores) at 495 TFLOP/s, or
    the bytes."""
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
        b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
        out[name] = {"m": m, "n": n, "k": k, "bound_ms": b_ms,
                     "bound_by": b_by, **timed(fns)}
    return out


def check_batched_order_stat(gen):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_batched_plain,
        order_statistic_reductions_batched,
    )

    kinds = ("duplicates", "equal", "bin90", "sorted", "subnormal")
    max_err, sum_rel_err, cases = 0.0, 0.0, 0
    for lead, n in BATCHED_OS_SHAPES:
        # Row i < 5 of kind kinds[i] (where the stack has it), the rest randn.
        x = torch.stack([_os_row(kinds[i] if i < len(kinds) else "randn", n,
                                 gen) for i in range(lead)])
        picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                 1]
        ranks = torch.tensor([picks[i % 4] for i in range(lead)],
                             dtype=torch.int32, device="cuda")

        def launch():
            return torch.stack(order_statistic_reductions_batched(x, ranks))

        first = launch()
        _same_bits(f"batched order stat ({lead}, {n})", launch, first)
        got = first.cpu()
        want = torch.stack(order_statistic_batched_plain(x, ranks)).cpu()
        if not torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)):
            raise AssertionError(f"batched order stat ({lead}, {n}): "
                                 f"{got[0]} != {want[0]}")
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"batched max ({lead}, {n})")
        rel = ((got[2] - want[2]).abs()
               / want[2].abs().clamp_min(1e-30)).max().item()
        if rel > 1e-6:
            raise AssertionError(f"batched sum ({lead}, {n}): rel {rel}")
        max_err = max(max_err, (got[:2] - want[:2]).abs().max().item())
        sum_rel_err = max(sum_rel_err, rel)
        cases += lead
    return max_err, sum_rel_err, cases


def stream_ops_per_call(fn, iters=20):
    """Operations ``fn`` puts on the stream a call, by the profiler: its
    kernels and memsets (every device-side event). The profiler now and
    then records a window's device events wrongly (none, one of twenty
    missing, or more than the calls made, as :func:`device_ms` finds), so
    a window whose count is not a nonzero multiple of ``iters`` is traced
    again, four times at most; then the last window's count is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        count = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if count and count % iters == 0:
            break
        print(f"stream_ops_per_call: a window recorded {count} device "
              f"events in {iters} calls; traced again", file=sys.stderr)
    return count / iters


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


def _attn_f64(q, k, v, scale, bias, one_tf32_pass=False):
    """A float64 forward of float32 q, k, v on the card: o, and each
    element's Σ_j p_j·|v_j|. With ``one_tf32_pass``, every operand of the
    two products (q, k, then p and v) is rounded to TF32 first and each
    product summed exactly: one TF32 pass, the control."""
    def operand(x):
        x = x.float().contiguous()
        return (_tf32_rna(x) if one_tf32_pass else x).double()

    s = operand(q) @ operand(k).transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.double()
    # The kernel's guard, -1e30 in float32 (below -1e30 in float64, and
    # equal to the padding bias, so a fully padded row stays uniform).
    m = torch.clamp(s.amax(dim=-1, keepdim=True),
                    min=float(np.float32(-1e30)))
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    if one_tf32_pass:
        p = operand(p)
    vv = operand(v)
    return p @ vv, p @ vv.abs()


def _attn_f64_rel_err(name, o, q, k, v, scale, bias):
    """The float32 forward's o against float64, each element's error over
    its Σ_j p_j·|v_j|; fails past F64_REL_TOL. One TF32 pass a product on
    the same inputs must fail that bound, so that it tells 3xTF32 from one
    pass on this data. Returns both errors."""
    want, size = _attn_f64(q, k, v, scale, bias)

    def rel(out):
        return ((out.double() - want).abs() / size).max().item()

    err = rel(o)
    if err > F64_REL_TOL:
        raise AssertionError(f"{name}: {err} of Σ p|v| from float64 "
                             f"(bound {F64_REL_TOL})")
    one = rel(_attn_f64(q, k, v, scale, bias, one_tf32_pass=True)[0])
    if one <= F64_REL_TOL:
        raise AssertionError(f"{name}: one TF32 pass, {one}, meets the "
                             f"bound {F64_REL_TOL}: it cannot tell")
    return err, one


def check_attention(gen):
    """Forward and backward kernels against their plain versions; o and
    dq, dk, dv within rtol/atol 1e-4 (float32) or 2e-2 (bfloat16); each
    kernel launched twice a case, and the two must agree bit for bit. The
    float32 forward also against float64 (_attn_f64_rel_err), with one
    TF32 pass as the control."""
    from atq_tpu_torch.ops import fused_attention as fa

    errs = {"fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0}
    by_case = []
    for shape, dtype, with_bias in ATTN_CASES:
        q, k, v, do, bias = _attn_inputs(gen, shape, dtype, with_bias)
        scale = 1.0 / float(np.sqrt(shape[3]))
        tol = ATTN_TOL[dtype]

        def forward():
            return fa.fused_attention_forward(q, k, v, scale, bias)

        o = forward()
        _same_bits(f"attention fwd {shape} {dtype}", forward, o)
        if not torch.isfinite(o).all():
            raise AssertionError(f"attention {shape}: non-finite output")
        case = {"shape": shape, "dtype": str(dtype), "bias": with_bias}
        case["fwd"] = _err(f"attention fwd {shape} {dtype}", o.float(),
                           fa.forward_plain(q, k, v, scale, bias).float(),
                           tol)
        if dtype == torch.float32:
            case["fwd_f64_rel_err"], case["fwd_one_tf32_pass"] = \
                _attn_f64_rel_err(f"attention fwd {shape}", o, q, k, v,
                                  scale, bias)

        def backward():
            return torch.cat([g.flatten() for g in fa.fused_attention_backward(
                q, k, v, scale, bias, do)])

        flat = backward()
        _same_bits(f"attention bwd {shape} {dtype}", backward, flat)
        grads = flat.view(3, *shape).unbind(0)
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
    kernels, plain versions, and scaled_dot_product_attention as the
    yardstick: its forward for the forward row; for the backward row its
    backward alone (autograd.grad on a retained graph, the same function
    as the kernel), with forward+backward beside it."""
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

    o_sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, leaves, do, retain_graph=True)

    elems = b * h * s * d
    # The forward's two products on the tensor cores as 3xTF32: three TF32
    # products each, 3 * 4 * S^2 * D operations a head.
    fwd_ms, fwd_by = bound(4 * elems * 4, 3 * 4 * s * s * d * b * h,
                           PEAK_TF32_FLOP_PER_S)
    # The backward's five products on the tensor cores as 3xTF32: three
    # TF32 products each, 3 * 10 * S^2 * D operations a head.
    bwd_ms, bwd_by = bound(7 * elems * 4, 3 * 10 * s * s * d * b * h,
                           PEAK_TF32_FLOP_PER_S)

    def kernel_bwd():
        return fa.fused_attention_backward(q, k, v, scale, None, do)

    def library_fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)
    return {
        "fused_attention_fwd": {
            "shape": shape, "bound_ms": fwd_ms, "bound_by": fwd_by,
            "library_kernels_device_ms": device_ms_by_kernel(library_fwd),
            **timed({"kernel": lambda: fa.fused_attention_forward(
                q, k, v, scale),
                "plain": lambda: fa.forward_plain(q, k, v, scale),
                "library": library_fwd})},
        "fused_attention_bwd": {
            "shape": shape, "bound_ms": bwd_ms, "bound_by": bwd_by,
            "library_is": "sdpa backward",
            # The device ms of each of the kernel's launches, and the names
            # of the kernels SDPA's backward ran (its backend).
            "kernel_launches_device_ms": device_ms_by_kernel(kernel_bwd),
            "library_kernels_device_ms": device_ms_by_kernel(sdpa_bwd),
            **timed({"kernel": kernel_bwd,
                     "plain": lambda: fa.backward_plain(q, k, v, scale, None,
                                                        do),
                     "library": sdpa_bwd, "library_fwd_bwd": sdpa_fwd_bwd})},
    }


def _host_us(fn, calls, repeats):
    """Host microseconds a call of ``fn`` over ``repeats`` windows of
    ``calls`` calls, each window ended by a synchronize."""
    out = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / calls * 1e6)
    return out


def op_dispatch_us(gen, calls=200, repeats=7):
    """What a registered op adds on the host: each op called through
    ``torch.ops.atq_tpu_torch`` (the custom op's dispatch, then the ctypes
    launch) against its CUDA implementation called directly (the launch
    alone), at small shapes where the host sets the pace; the two
    alternate window by window, and each reads the median of its
    windows. The training steps call the order statistic (27 a step in
    train_retrieval) and, under ATQ_FUSED=1, the fused forward through
    these ops."""
    from atq_tpu_torch.core.packing import pack_planar
    from atq_tpu_torch.ops import fused_linear, order_stat, ternary_matmul

    ops = torch.ops.atq_tpu_torch
    rows = torch.randn(16384, generator=gen, device="cuda").abs()
    rank = torch.tensor([4915], dtype=torch.int32, device="cuda")
    x = torch.randn(16, 256, generator=gen, device="cuda")
    w = torch.randn(64, 256, generator=gen, device="cuda")
    scal = torch.tensor([0.7, 0.4], device="cuda")
    planes = pack_planar(torch.sign(w).cpu()).cuda()
    cases = {
        "order_stat": ((rows, rank), ops.order_stat,
                       order_stat._order_stat_cuda),
        "fused_forward": ((x, w, None, scal), ops.fused_forward,
                          fused_linear._forward_cuda),
        "ternary_matmul": ((x, planes, 256, scal, False),
                           ops.ternary_matmul, ternary_matmul._planar_cuda),
    }
    out = {}
    for name, (args, op, direct) in cases.items():
        if not torch.equal(op(*args), direct(*args)):
            raise AssertionError(f"op dispatch: {name} op and direct "
                                 f"launch differ")
        both = {"op": [], "direct": []}
        for _ in range(repeats):
            both["op"] += _host_us(lambda: op(*args), calls, 1)
            both["direct"] += _host_us(lambda: direct(*args), calls, 1)
        med = {k: float(np.median(v)) for k, v in both.items()}
        out[name] = {**med, "added": med["op"] - med["direct"]}
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dispatch = op_dispatch_us(gen)
    os_err, os_sum_rel_err, os_cases = check_order_stat(gen)
    mm_err, mm_cases = check_matmul(gen)
    fused_errs, fused_f64, da_rel, fused_cases = check_fused(gen)
    bos_err, bos_sum_rel, bos_rows = check_batched_order_stat(gen)
    attn_errs, attn_cases = check_attention(gen)
    packed_errs, packed_cases = check_packed_kernels(gen)
    # Both order statistics at the main paths' shapes, with their stream
    # operations a call (each must be 1: one launch, no memset) and the
    # launch's plan (CTAs a row, whether the row stays in shared memory).
    from atq_tpu_torch.ops.order_stat import kernel_plan

    os_rows = order_stat_rows(sys.modules[__name__], gen)
    for row in os_rows:
        row.update(kernel_plan(row["n"], row.get("lead", 1), "cuda"))
    bad = [r for r in os_rows if r["stream_ops"] != 1]
    if bad:
        raise AssertionError(f"order statistic: not one stream operation "
                             f"a call: {bad}")
    timings = {
        "order_stat": [r for r in os_rows if "lead" not in r],
        "batched_order_stat": [r for r in os_rows if "lead" in r],
        "ternary_matmul": [time_matmul(gen, MAX_BATCH, n, k)
                           for n, k in MM_SHAPES[:2]]
        + [time_matmul(gen, 1, n, k) for n, k in MM_SHAPES[:2]]
        # the shape that routes to _kernel_kblocked in JAX
        + [time_matmul(gen, 128, 128, 8704)],
    }
    for shape in FUSED_SHAPES[:2]:  # the recipe's two head layers
        for name, t in time_fused(gen, *shape).items():
            timings.setdefault(name, []).append(t)
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
          "fused_f64_rel_err": fused_f64, "f64_rel_tol": F64_REL_TOL,
          "batched_order_stat_rows": bos_rows,
          "batched_order_stat_max_abs_err": bos_err,  # statistic and max
          "batched_order_stat_sum_max_rel_err": bos_sum_rel,
          "attention_cases": attn_cases,
          # float32 forward over Σ p|v| from float64: the kernel's largest,
          # one TF32 pass's least (F64_REL_TOL between them)
          "attention_fwd_f64_rel_err": {
              "kernel": max(c["fwd_f64_rel_err"] for c in attn_cases
                            if "fwd_f64_rel_err" in c),
              "one_tf32_pass": min(c["fwd_one_tf32_pass"] for c in attn_cases
                                   if "fwd_one_tf32_pass" in c)},
          "packed_cases": packed_cases,
          "packed_max_abs_err": packed_errs, "timings": timings,
          "op_dispatch_us": dispatch})
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
    busy = _profiled_breakdown(prof, 1, traced_wall)[0]["share"]

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
          "device_busy_share": busy or None,
          "max_abs_err_vs_cpu": float(np.abs(logits - reference).max())})
    return logits, launches


# serve_packed's PackedClassifier (serve/packed_model.py): one batch of
# PACKED_CLF_BATCH synthetic Fashion-MNIST images (serve_packed's 64 first,
# the test split's first images after them) through the classifier's
# deployment form, within PACKED_CLF_TOL (serve_dense's tolerance, rtol and
# atol) of the same class on the CPU and of serve_packed's /predict logits.
PACKED_CLF_BATCH, PACKED_CLF_TOL = 256, 1e-4


def _host_syncs(fn):
    """``fn()``'s result and the number of times it made the host wait
    for the card (torch.cuda.set_sync_debug_mode's warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def eval_syncs(model, images, labels):
    """The host waits of the classifier's eval loop (train/classifier.py
    ``_run_eval`` over ``build_eval_step``), which the trainer's
    validation and ``python -m atq_tpu_torch.evaluate`` run, over one
    batch and over four, after a first call (whose one-off set-up may
    wait once more): one read at the end, none a batch. A planted
    ``.item()`` must count one; the model's bare forward is read beside."""
    from atq_tpu_torch.train.classifier import _run_eval, build_eval_step

    dev = torch.device("cuda")
    step = build_eval_step(model)
    _, first = _host_syncs(lambda: _run_eval(step, [(images, labels)], dev))
    counts = {}
    for n in (1, 4):
        loader = [(images, labels)] * n
        _, counts[n] = _host_syncs(lambda: _run_eval(step, loader, dev))
    _, planted = _host_syncs(lambda: torch.zeros((), device=dev).item())
    x = torch.as_tensor(images, device=dev)
    with torch.inference_mode():
        _, forward = _host_syncs(lambda: model(x))
    if planted != 1 or counts != {1: 1, 4: 1}:
        raise AssertionError(f"eval loop syncs {counts}, planted "
                             f"{planted}")
    return {"eval_first_call": first, "eval_1_batch": counts[1],
            "eval_4_batches": counts[4],
            "planted_item": planted, "forward": forward}


def phase_packed_classifier(path, served_images, served_logits):
    """``PackedClassifier`` on the card on serve_packed's checkpoint: one
    batch against its CPU plain path and the served logits, its kernel
    launches (the packed matmul, once a head layer) and its
    ``memory_footprint_bytes``; and the eval loop's host waits
    (:func:`eval_syncs`) on its model."""
    from atq_tpu_torch.data.mnist import FASHION_STATS, synthetic_test_set
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve import PackedClassifier
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    ckpt = load_checkpoint(path)
    more = synthetic_test_set("fashion_mnist", PACKED_CLF_BATCH)[0][
        :PACKED_CLF_BATCH - len(served_images)].astype(np.float32) / 255.0
    mean, std = FASHION_STATS
    x = ((np.concatenate([served_images, more]) - mean) / std)[..., None]
    args = (ckpt["params"], ckpt["quant"], ckpt["batch_stats"])
    card = PackedClassifier(*args, use_rpb=True, hidden_size=128,
                            device="cuda")
    cpu = PackedClassifier(*args, use_rpb=True, hidden_size=128,
                           device="cpu")
    card(x)  # first batch: cuDNN set-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    got = card(x)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kernel_launches().items() if v}
    got, want = got.cpu().numpy(), cpu(x).numpy()
    served = got[:len(served_images)]
    if got.shape != (PACKED_CLF_BATCH, 10) or not np.isfinite(got).all():
        raise AssertionError(f"PackedClassifier: bad logits {got.shape}")
    np.testing.assert_allclose(got, want, rtol=PACKED_CLF_TOL,
                               atol=PACKED_CLF_TOL,
                               err_msg="PackedClassifier vs its CPU path")
    np.testing.assert_allclose(served, served_logits, rtol=PACKED_CLF_TOL,
                               atol=PACKED_CLF_TOL,
                               err_msg="PackedClassifier vs /predict")
    if launches != {"ternary_matmul": 2}:
        raise AssertionError(f"PackedClassifier launches {launches}")
    footprint = card.memory_footprint_bytes()
    if footprint != cpu.memory_footprint_bytes():
        raise AssertionError("PackedClassifier footprint card vs CPU")
    labels = np.random.default_rng(0).integers(
        0, 10, PACKED_CLF_BATCH).astype(np.int64)
    syncs = eval_syncs(card.model, x.astype(np.float32), labels)
    emit({"phase": "packed_classifier", "batch": PACKED_CLF_BATCH,
          "max_abs_err_vs_cpu": float(np.abs(got - want).max()),
          "max_abs_err_vs_served": float(np.abs(served
                                               - served_logits).max()),
          "tol": PACKED_CLF_TOL, "launches": launches,
          "batch_ms": batch_ms,
          "memory_footprint_bytes": footprint, "eval_host_syncs": syncs})
    return launches


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
    busy = _profiled_breakdown(prof, 1, traced_wall)[0]["share"]
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
          "device_busy_share": busy or None,
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


EVAL_ARGV = {  # the slice's evaluate commands, less --device and outputs
    "classification": ["--task", "classification", "--use-rpb"],
    "classification_packed": ["--task", "classification", "--use-rpb",
                              "--packed"],
    "retrieval": RETRIEVAL_ARGV + ["--int8_trunk"],
}
EVAL_LOGIT_TOL = 1e-4  # serve_dense's logits tolerance (rtol and atol)
CLF_EVAL_IMAGES, EVAL_BATCH = 10000, 256  # the synthetic test split
RET_EVAL_ROWS = 200  # the synthetic corpus's test split: 40 images x 5


def _card_outputs(name, ckpt, data_dir, device="cuda"):
    """What the evaluate command ``name`` computes on the card, computed
    again here for the slack of its metrics: the classifier's logits, or
    the retrieval split's embeddings and its first image of each name.
    With ``device="cpu"``, the retrieval split's text embeddings alone
    (the image tower's are held through the saved index)."""
    from atq_tpu_torch.evaluate import build_parser as eval_parser
    from atq_tpu_torch.serve.__main__ import (
        build_classifier,
        build_retrieval,
    )
    from atq_tpu_torch.train.retrieval import _batch_to, build_embed_fn
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    dev = torch.device(device)
    args = eval_parser().parse_args(EVAL_ARGV[name]
                                    + ["--checkpoint", ckpt])
    if name.startswith("classification"):
        from atq_tpu_torch.data.mnist import get_fashion_mnist_data

        _, _, loader = get_fashion_mnist_data(EVAL_BATCH, data_dir,
                                              subset_fraction=1.0)
        model = build_classifier(args, load_checkpoint(ckpt), "parity", dev)
        with torch.inference_mode():
            return np.concatenate([model(torch.from_numpy(x).to(dev))
                                   .cpu().numpy() for x, _ in loader])
    from atq_tpu_torch.data.flickr8k import prepare_flickr8k_dataloaders

    vocab = os.path.join(os.path.dirname(ckpt), "vocab.json")
    _, _, loader, vocab_size, _ = prepare_flickr8k_dataloaders(
        batch_size=EVAL_BATCH, image_size=IMAGE_SIZE, max_length=SEQ_LEN,
        root_dir=data_dir, vocab_file=vocab)
    model = build_retrieval(args, load_checkpoint(ckpt), "parity", dev,
                            vocab_size)
    if device == "cpu":
        with torch.inference_mode():
            return np.concatenate([model.encode_text(*_batch_to(
                batch, dev)[1:3]).numpy() for batch in loader])
    embed = build_embed_fn(model)
    names = [n for n, _ in loader.dataset.items]
    img, txt, first = [], [], {}
    for batch in loader:
        row = sum(len(a) for a in img)
        for n, image in zip(names[row:], batch[0]):
            first.setdefault(n, image)
        a, b = embed(_batch_to(batch, dev))
        img.append(a.cpu().numpy())
        txt.append(b.cpu().numpy())
    return np.concatenate(img), np.concatenate(txt), first


def _accuracy_slack(logits):
    """The most the accuracy (percentage points) can move when every logit
    moves within serve_dense's tolerance: 100 / n for each image whose two
    largest logits lie within twice that of each other."""
    top2 = np.sort(logits, axis=1)[:, -2:]
    tol = EVAL_LOGIT_TOL * (1.0 + np.abs(top2[:, 1]))
    return 100.0 * float(np.mean(top2[:, 1] - top2[:, 0] < 2 * tol))


def _recall_slack(img, txt, atol):
    """Per R@K key, the most the metric can move (percentage points) when
    every embedding moves within ``atol`` (serve_retrieval's card vs CPU
    tolerance; a score, by less than ``2 * atol``): 100 / n for each query
    with another score that close to its target's. The dedup keys count
    their unique-gallery queries the same way."""
    n = min(len(img), len(txt))
    rows = np.arange(n)

    def share(s, target_col):
        target = s[rows, target_col][:, None]
        near = np.abs(s - target) < 2 * atol
        near[rows, target_col] = False
        return 100.0 * float(near.any(axis=1).mean())

    sims = img @ txt.T
    uniq, owner = np.unique(img, axis=0, return_inverse=True)
    out = {"image_to_text": share(sims[:n], rows),
           "text_to_image": share(sims[:, :n].T, rows),
           "dedup": share(txt[:n] @ uniq.T, owner.reshape(-1)[:n])}
    out["mean"] = (out["image_to_text"] + out["text_to_image"]) / 2
    return out


def _search_own_images(ret_path, index_file, first):
    """``serve --index_file`` preloads the saved index, and ``/search``
    with each corpus image (sent alone, normalized) answers that image
    as its top-1."""
    from atq_tpu_torch.serve.__main__ import build_server
    from atq_tpu_torch.serve.http import start_in_thread

    httpd, servers, info = build_server(
        RETRIEVAL_ARGV + ["--checkpoint", ret_path, "--port", "0",
                          "--index_file", index_file])
    thread = start_in_thread(httpd)
    try:
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda im: _post_json(
                info["port"], "/search", {"image": im.tolist(), "k": 2})[0],
                first.values()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        for s in servers:
            s.stop()
    top1 = [a["results"][0]["id"] for a in answers]
    wrong = [(n, t) for n, t in zip(first, top1) if n != t]
    if wrong or answers[0]["count"] != len(first):
        raise AssertionError(f"evaluate: /search over the saved index: "
                             f"{len(wrong)} images not their own top-1 "
                             f"({wrong[:3]}), count {answers[0]['count']}")
    return {"searches": len(first), "own_top1": len(first) - len(wrong),
            "min_top2_gap": float(min(a["results"][0]["score"]
                                      - a["results"][1]["score"]
                                      for a in answers))}


# evaluate's text embeddings, card against CPU, module by module (the
# trained retrieval checkpoint, dense and --packed, the test split's text
# batch at the evaluation's batch): each module's output on the card in
# the card's own forward ("chained") and run again on the card on the
# CPU's inputs to it ("local"), against the CPU's, by max |difference|
# beside the CPU output's max |value|; a packed layer's terms
# (serve/packed_model.py ``_packed_terms``: the kernel, the ELL and COO
# sums) on the CPU's inputs; each attention's largest |score| (q·kᵀ/√d on
# the CPU) and its scores' distance on the CPU's q and k (the attention's
# own product, as nn/attention.py computes it). ``grows_at`` is the first
# module whose chained distance, relative to its output's scale, reaches
# a tenth of the embedding's.
TEXT_LAYER_MODULES = ("norm1", "self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj", "self_attn.out_proj", "self_attn",
                      "norm2", "linear1", "linear2", "")
TEXT_HEADS = 8


def _text_module_names(n_layers):
    names = ["text_encoder.embedding", "text_encoder.embed_norm"]
    for i in range(n_layers):
        names += [f"text_encoder.layers_{i}" + (f".{m}" if m else "")
                  for m in TEXT_LAYER_MODULES]
    return names + ["text_encoder.norm", "text_encoder.attention_pool_0",
                    "text_encoder.attention_pool_2", "text_encoder",
                    "text_projector", "text_norm"]


def _to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    return obj


def _recorded_forward(model, names, fn):
    """``fn()`` with each named module's (args, kwargs, output) of the call
    recorded, by name."""
    store, handles = {}, []
    for name in names:
        def hook(mod, args, kwargs, out, name=name):
            store[name] = (args, kwargs, out)

        handles.append(model.get_submodule(name).register_forward_hook(
            hook, with_kwargs=True))
    try:
        with torch.inference_mode():
            out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, store


def _max_abs(a, b=None):
    d = a.float() if b is None else a.float().cpu() - b.float().cpu()
    return float(d.abs().max())


def text_tower_modules(ckpt, data_dir, packed):
    """The module-by-module reading of the text tower above on ``ckpt``
    (dense, or ``packed``): a line each, then the summary, returned."""
    from atq_tpu_torch.data.flickr8k import prepare_flickr8k_dataloaders
    from atq_tpu_torch.evaluate import build_parser as eval_parser
    from atq_tpu_torch.serve.__main__ import build_retrieval
    from atq_tpu_torch.serve.packed_model import _packed_terms
    from atq_tpu_torch.train.retrieval import _batch_to
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    argv = [a for a in RETRIEVAL_ARGV if packed or a != "--packed"]
    args = eval_parser().parse_args(argv + ["--checkpoint", ckpt])
    _, _, loader, vocab_size, _ = prepare_flickr8k_dataloaders(
        batch_size=EVAL_BATCH, image_size=IMAGE_SIZE, max_length=SEQ_LEN,
        root_dir=data_dir, vocab_file=os.path.join(os.path.dirname(ckpt),
                                                   "vocab.json"))
    weights = load_checkpoint(ckpt)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    models = {d: build_retrieval(args, weights, "parity", d, vocab_size)
              for d in (cuda, cpu)}
    ids, lengths = _batch_to(next(iter(loader)), cpu)[1:3]
    names = _text_module_names(models[cpu].text_encoder.num_layers)
    outs = {d: _recorded_forward(models[d], names,
                                 lambda d=d: models[d].encode_text(
                                     ids.to(d), lengths.to(d)))
            for d in (cuda, cpu)}
    mode = "packed" if packed else "dense"
    lines = []
    for name in names:
        args_, kwargs, ref = outs[cpu][1][name]
        mod = models[cuda].get_submodule(name)
        with torch.inference_mode():
            local = mod(*_to_device(args_, cuda), **_to_device(kwargs, cuda))
        line = {"module": name, "local": _max_abs(local, ref),
                "chained": _max_abs(outs[cuda][1][name][2], ref),
                "ref": _max_abs(ref)}
        entry = getattr(mod, "packed_entry", None)
        if entry is not None:
            x = args_[0].reshape(-1, args_[0].shape[-1])
            cpu_entry = models[cpu].get_submodule(name).packed_entry
            with torch.inference_mode():
                got = _packed_terms(entry, x.to(cuda))
                want = _packed_terms(cpu_entry, x)
            line["terms"] = {k: _max_abs(got[k], want[k]) for k in want}
        if name.endswith(".self_attn"):
            q, k = (mod._split(outs[cpu][1][f"{name}.{p}_proj"][2],
                               ids.shape[0]) for p in "qk")
            scale = 1.0 / mod.head_dim ** 0.5
            with torch.inference_mode():
                scores = [torch.matmul(q.to(d), k.to(d).transpose(-1, -2))
                          * scale for d in (cuda, cpu)]
            line["max_abs_score"] = _max_abs(scores[1])
            line["score_local"] = _max_abs(*scores)
        emit({"phase": "evaluate_text_modules", "mode": mode, **line})
        lines.append(line)
    final = _max_abs(outs[cuda][0], outs[cpu][0])
    scale = _max_abs(outs[cpu][0])
    grows_at = next((ln["module"] for ln in lines
                     if ln["chained"] / max(ln["ref"], 1e-30)
                     >= 0.1 * final / scale), None) if final else None
    largest = max(lines, key=lambda ln: ln["local"] / max(ln["ref"], 1e-30))
    summary = {"mode": mode, "rows": int(ids.shape[0]),
               "text_max_abs_err": final, "limit": RETRIEVAL_ATOL,
               "grows_at": grows_at,
               "largest_local": {k: largest[k] for k in
                                 ("module", "local", "ref")}}
    emit({"phase": "evaluate_text_modules", **summary})
    if not final <= RETRIEVAL_ATOL:
        raise AssertionError(f"evaluate text tower ({mode}): {final}")
    return summary


def phase_evaluate(clf_path, ret_path, tmp):
    """``python -m atq_tpu_torch.evaluate``'s main() on the card on the
    trained checkpoints (train_dense's classifier, train_retrieval's
    best_model.npz), each command held against itself with --device cpu:
    the classifier dense and --packed on the synthetic Fashion-MNIST test
    split (accuracy within the slack of near-tied logits, loss within rtol
    1e-4), the README retrieval model --packed --int8_trunk --save_index
    on the synthetic corpus's test split (the index's ids equal and its
    embeddings within 1e-3 of the CPU's, the split's text embeddings at the
    evaluation's batch within 1e-3 of the CPU's, and R@K within the slack
    of near-tied scores); the card's index preloaded by ``serve
    --index_file``, each
    image its own /search top-1. Launches counted on the card runs."""
    from atq_tpu_torch.evaluate import main as evaluate_main
    from atq_tpu_torch.ops import kernel_launches

    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "no_data")  # the synthetic stand-ins
    ckpt = {"classification": clf_path, "classification_packed": clf_path,
            "retrieval": ret_path}
    runs, launches = {}, {}
    for name, argv in EVAL_ARGV.items():
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"eval_{name}_{device}.json")
            extra = ["--checkpoint", ckpt[name], "--device", device,
                     "--output", out, "--data_dir", data_dir]
            if name == "retrieval":
                extra += ["--save_index",
                          os.path.join(tmp, f"index_{device}.npz")]
            _reset_launches()
            t = time.perf_counter()
            metrics = evaluate_main(argv + extra)
            if device == "cuda":
                torch.cuda.synchronize()
                launches[name] = {k: v for k, v in kernel_launches().items()
                                  if v}
            with open(out) as f:
                written = json.load(f)
            if written != {k: float(v) for k, v in metrics.items()}:
                raise AssertionError(f"evaluate {name}: --output {written}")
            runs[(name, device)] = (written, time.perf_counter() - t)
    readings = {}
    for name in ("classification", "classification_packed"):
        got, want = runs[(name, "cuda")][0], runs[(name, "cpu")][0]
        slack = _accuracy_slack(_card_outputs(name, clf_path, data_dir))
        readings[name] = {
            "cuda": got, "cpu": want,
            "accuracy_diff": abs(got["accuracy"] - want["accuracy"]),
            "accuracy_slack": slack,
            "loss_rel_diff": abs(got["loss"] - want["loss"]) / abs(
                want["loss"]), "loss_rtol": EVAL_LOGIT_TOL}
        if readings[name]["accuracy_diff"] > slack or \
                readings[name]["loss_rel_diff"] > EVAL_LOGIT_TOL:
            raise AssertionError(f"evaluate {name}: {readings[name]}")
    img, txt, first = _card_outputs("retrieval", ret_path, data_dir)
    # The text tower at the evaluation's batch (EVAL_BATCH x SEQ_LEN rows
    # a packed launch), card against CPU: the tight check of the text
    # half, as the saved index is of the image half. R@K is reported
    # beside the slack of near-tied scores.
    text_err = float(np.abs(txt - _card_outputs(
        "retrieval", ret_path, data_dir, device="cpu")).max())
    slack = _recall_slack(img, txt, RETRIEVAL_ATOL)
    got, want = runs[("retrieval", "cuda")][0], runs[("retrieval", "cpu")][0]
    diffs = {k: abs(got[k] - want[k]) for k in want}
    limits = {k: slack["dedup" if k.endswith("_dedup")
                       else k.split("_R@")[0]] for k in want}
    bad = {k: (diffs[k], limits[k]) for k in want if diffs[k] > limits[k]}
    card_index, cpu_index = (np.load(os.path.join(tmp, f"index_{d}.npz"),
                                     allow_pickle=True)
                             for d in ("cuda", "cpu"))
    ids = list(card_index["ids"])
    index_err = float(np.abs(card_index["embeddings"]
                             - cpu_index["embeddings"]).max())
    if bad or ids != list(cpu_index["ids"]) or ids != list(first) \
            or index_err > RETRIEVAL_ATOL or text_err > RETRIEVAL_ATOL:
        raise AssertionError(f"evaluate retrieval: R@K beyond slack {bad}, "
                             f"index ids equal "
                             f"{ids == list(cpu_index['ids'])}, index "
                             f"err {index_err}, text err {text_err} "
                             f"(limit {RETRIEVAL_ATOL})")
    search = _search_own_images(ret_path, os.path.join(tmp, "index_cuda.npz"),
                                first)
    t = time.perf_counter()
    text_modules = [text_tower_modules(ret_path, data_dir, packed)
                    for packed in (False, True)]
    text_modules_seconds = time.perf_counter() - t
    batches = -(-CLF_EVAL_IMAGES // EVAL_BATCH)
    ret_batches = -(-RET_EVAL_ROWS // EVAL_BATCH)
    want_launches = {
        "classification": {"order_stat": batches},
        "classification_packed": {"ternary_matmul": 2 * batches},
        # the evaluation pass and --save_index's pass embed both towers
        "retrieval": {"ternary_matmul": 2 * ret_batches * (
            IMAGE_LAUNCHES + TEXT_LAUNCHES)}}
    for name, want_l in want_launches.items():
        if launches[name] != want_l:
            raise AssertionError(f"evaluate {name}: launches "
                                 f"{launches[name]}, expected {want_l}")
    emit({"phase": "evaluate", "classification": readings,
          "retrieval": {"cuda": got, "cpu": want, "abs_diff": diffs,
                        "slack": limits, "index_images": len(ids),
                        "index_max_abs_err": index_err,
                        "text_rows": len(txt),
                        "text_max_abs_err": text_err,
                        "embedding_limit": RETRIEVAL_ATOL},
          "search": search, "launches": launches,
          "text_modules": text_modules,
          "text_modules_seconds": text_modules_seconds,
          "seconds_by_run": {f"{n}_{d}": s for (n, d), (_, s) in
                             runs.items()},
          "seconds": time.perf_counter() - t0})
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


AOT_START_TIMEOUT_S = 600  # a server process: start, export or load


class _ServerProcess:
    """``python -m atq_tpu_torch.serve ARGV --port 0`` in a process of its
    own, up to its first answered request: ``seconds`` from the process's
    start to that answer, its ``{"aot": ...}`` line, and the answer."""

    def __init__(self, argv, first_request):
        self.lines = []
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "atq_tpu_torch.serve", *argv,
             "--port", "0", "--max_batch", str(MAX_BATCH)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            info = _read_until(self.proc, '"serving"', AOT_START_TIMEOUT_S,
                               self.lines)
            if info is None:
                raise AssertionError(f"serve {argv[:2]}: no server line: "
                                     f"{self.lines[-20:]}")
            self.answer = first_request(json.loads(info)["port"])
            self.seconds = time.perf_counter() - t0
        finally:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        aot = [json.loads(x) for x in self.lines if x.startswith('{"aot"')]
        self.aot = {a["path"].rsplit(os.sep, 1)[1]: a for a in aot}


# The traced windows whose kernel events must equal counted launches record
# the host as well, as the trainers' traces do (utils/profile_step.py
# start_trace).
_TRACED = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]


def _kernel_events(prof, name):
    """Device events of ``prof`` (a finished in-process capture) whose
    kernel name holds ``name``."""
    from atq_tpu_torch.utils.profile_step import DEVICE_CATEGORIES

    _, events = _profiled_breakdown(prof, 1, 1.0)
    return sum(name in e.get("name", "") for e in events
               if e.get("cat") in DEVICE_CATEGORIES)


def _traced_loaded_server(argv, burst, kernel, want_per_batch):
    """The server built in-process from the artifact (``--aot`` finds it:
    loaded), a warm-up request and a traced burst: its answers, counted
    launches, ``tiled_packed_kernel`` events and batches, and the launches
    it should make (``want_per_batch(batches)``); and the programs its
    servers ran. The profiler now and then
    loses a kernel event (as ``device_ms`` finds), so a burst whose events
    differ from its exact launch count is traced again, twice at most."""
    from torch.profiler import profile

    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.__main__ import build_server
    from atq_tpu_torch.serve.http import start_in_thread

    httpd, servers, info = build_server(argv + ["--port", "0",
                                                "--max_batch",
                                                str(MAX_BATCH)])
    thread = start_in_thread(httpd)
    events = []
    try:
        burst(info["port"], warm=True)
        for _ in range(3):
            before = [s.stats["batches"] for s in servers]
            _reset_launches()
            with profile(activities=_TRACED) as prof:
                answers = burst(info["port"], warm=False)
                torch.cuda.synchronize()
            launches = {k: v for k, v in kernel_launches().items() if v}
            batches = [s.stats["batches"] - b
                       for s, b in zip(servers, before)]
            want = want_per_batch(batches)
            events.append(_kernel_events(prof, "tiled_packed_kernel"))
            if launches.get(kernel) != want or events[-1] == want:
                break
        failures = [s.stats["primary_failures"] for s in servers]
        programs = [s._apply for s in servers]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        for s in servers:
            s.stop()
    return {"answers": answers, "launches": launches, "events": events,
            "batches": batches, "want": want,
            "failures": failures}, programs


def traced_aot(spec_file):
    """``--traced-aot SPEC``: serve_aot's checks of the loaded artifacts,
    in a process of their own (traced late in the main process, a
    window's kernel events fell short of or ran over its launches, 5, 9
    and 7 events for 8; and once this phase had traced there, the kernels
    phase's windows did too). SPEC (JSON) names the checkpoints, the
    artifacts' CLI arguments and directories, where to export the dense
    predict program and the output file. Traced: the classifier's burst
    and the retrieval model's images alone and burst from the loaded
    servers, and two calls of the dense program, each with its launches
    and events. Then each program the servers ran, and the dense one, at
    batch 1 and MAX_BATCH equal to the live model on the card bit for
    bit."""
    from torch.profiler import profile

    from atq_tpu_torch.data.flickr8k import _synthetic_corpus
    from atq_tpu_torch.data.mnist import FASHION_STATS, synthetic_test_set
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.__main__ import (
        build_classifier,
        build_parser,
        build_retrieval,
    )
    from atq_tpu_torch.serve.aot import (
        AOTServing,
        export_serving,
        load_serving,
    )
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    os.environ["ATQ_NO_DOWNLOAD"] = "1"
    with open(spec_file) as f:
        spec = json.load(f)
    images = synthetic_test_set("fashion_mnist", N_REQUESTS)[0].astype(
        np.float32) / 255.0
    req = retrieval_requests(load_vocab(spec["ret_path"]),
                             _synthetic_corpus(400))

    def clf_burst(port, warm):
        if warm:
            return _post(port, images[0])
        return [a["logits"] for a, _ in _burst(port, images)[0]]

    def ret_burst(port, warm):
        if warm:
            return _post_json(port, "/embed_image",
                              _image_payload(req["images"][0]))
        alone = [a["embedding"] for a in _sequential_images(port, req)]
        _, txt, _, _ = _retrieval_burst(port, req)
        return alone, txt.tolist()

    out, programs = {}, {}
    for name, argv, path, burst, want in (
            ("classifier", spec["clf_argv"], spec["clf_dir"], clf_burst,
             lambda b: 2 * b[0]),
            ("retrieval", spec["ret_argv"], spec["ret_dir"], ret_burst,
             lambda b: IMAGE_LAUNCHES * b[0] + TEXT_LAUNCHES * b[1])):
        out[name], programs[name] = _traced_loaded_server(
            argv + ["--aot", path], burst, "ternary_matmul", want)
    if not all(isinstance(p, AOTServing)
               for progs in programs.values() for p in progs):
        raise AssertionError(f"serve_aot: a server ran no loaded program: "
                             f"{programs}")

    dev = torch.device("cuda")
    mean, std = FASHION_STATS
    x = torch.from_numpy(((images - mean) / std)[..., None]).to(dev)
    dense = build_classifier(build_parser().parse_args(
        [a for a in spec["clf_argv"] if a != "--packed"]),
        load_checkpoint(spec["clf_path"]), "parity", dev)
    dense_aot = load_serving(export_serving(dense, (x[:2],)).save(
        spec["dense_dir"]))
    if not dense_aot.batch_polymorphic:
        raise AssertionError("serve_aot dense predict: not polymorphic")
    events = []
    for _ in range(3):  # traced again where the trace lost an event
        _reset_launches()
        with profile(activities=_TRACED) as prof:
            for n in (1, MAX_BATCH):
                dense_aot(x[:n])
            torch.cuda.synchronize()
        launches = kernel_launches()["order_stat"]
        events.append(_kernel_events(prof, "order_stat_cluster_kernel"))
        if launches != 2 or events[-1] == 2:
            break
    out["dense_predict"] = {"launches": launches, "events": events,
                            "want": 2}

    # Each program at batch 1 and MAX_BATCH against the live model.
    clf_model = build_classifier(build_parser().parse_args(
        spec["clf_argv"]), load_checkpoint(spec["clf_path"]), "parity", dev)
    ret_model = build_retrieval(_retrieval_args(spec["ret_path"],
                                                "--packed"),
                                load_checkpoint(spec["ret_path"]), "parity",
                                dev, len(load_vocab(spec["ret_path"])))
    (predict,), (embed_image, embed_text) = (programs["classifier"],
                                             programs["retrieval"])
    x_img = torch.from_numpy(req["normalized"]).to(dev)
    tok = torch.from_numpy(req["tokens"]).to(dev)
    ln = torch.from_numpy(req["lengths"]).to(dev)
    with torch.inference_mode():
        for n in (1, MAX_BATCH):
            _equal_bits(f"predict batch {n}", predict(x[:n]),
                        clf_model(x[:n]))
            _equal_bits(f"dense predict batch {n}", dense_aot(x[:n]),
                        dense(x[:n]))
            _equal_bits(f"embed_image batch {n}", embed_image(x_img[:n]),
                        ret_model.encode_image(x_img[:n]))
            _equal_bits(f"embed_text batch {n}", embed_text(tok[:n], ln[:n]),
                        ret_model.encode_text(tok[:n], ln[:n]))
    out["bit_equal_to_live"] = ["predict", "embed_image", "embed_text",
                                "dense predict"]
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def _equal_bits(what, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"serve_aot {what}: loaded program vs live "
                             f"model, max abs diff "
                             f"{float((got - want).abs().max())}")


def phase_serve_aot(clf_path, ret_path, tmp, images, clf_ref, req, ret_ref,
                    beside):
    """``serve --aot``: each CLI run twice in processes of its own (the
    first exports, the second loads) beside a live one, seconds from
    process start to the first answer of each; the classifier --packed
    and the retrieval model --packed --int8_trunk. From the loaded
    artifacts, in a process of their own (traced_aot): the existing bursts
    traced (tiled_packed_kernel events = counted launches = packed layers
    x batches), answers against the CPU plain path as in serve_packed and
    serve_retrieval, a dense predict export's order_stat_cluster_kernel
    events = order statistics x calls, and each program at batch 1 and at
    MAX_BATCH equal to the live model on the card bit for bit. ``beside()``
    runs in a thread while that process runs, which reads no time either
    (the preemption drill: its own processes, no timed window); returns
    the launches and what ``beside()`` returned."""
    t0 = time.perf_counter()
    clf_argv = ["--task", "classification", "--checkpoint", clf_path,
                "--use-rpb", "--packed"]
    ret_argv = RETRIEVAL_ARGV + ["--checkpoint", ret_path]
    clf_dir, ret_dir = os.path.join(tmp, "aot_clf"), os.path.join(tmp,
                                                                  "aot_ret")
    cold, aot_lines = {}, {}

    def predict0(port):
        return _post(port, images[0])[0]["logits"]

    def embed0(port):
        return _post_json(port, "/embed_image",
                          _image_payload(req["images"][0]))[0]["embedding"]

    for task, argv, first, path in (("classification", clf_argv, predict0,
                                     clf_dir),
                                    ("retrieval", ret_argv, embed0,
                                     ret_dir)):
        runs = {"live": _ServerProcess(argv, first),
                "export": _ServerProcess(argv + ["--aot", path], first),
                "load": _ServerProcess(argv + ["--aot", path], first)}
        cold[task] = {k: r.seconds for k, r in runs.items()}
        aot_lines[task] = {k: r.aot for k, r in runs.items() if r.aot}
        for k, want_status in (("export", "exported"), ("load", "loaded")):
            status = {a["aot"] for a in runs[k].aot.values()}
            if status != {want_status} or not all(
                    a["batch_polymorphic"] for a in runs[k].aot.values()):
                raise AssertionError(f"serve_aot {task} {k}: "
                                     f"{runs[k].aot}")
        if not (runs["live"].answer == runs["export"].answer
                == runs["load"].answer):
            raise AssertionError(f"serve_aot {task}: first answers differ "
                                 f"between the live, exporting and "
                                 f"loading processes")
    processes_s = time.perf_counter() - t0

    # The loaded artifacts' checks, in a process of their own (traced_aot).
    spec = {"clf_argv": clf_argv, "ret_argv": ret_argv,
            "clf_dir": clf_dir, "ret_dir": ret_dir,
            "clf_path": clf_path, "ret_path": ret_path,
            "dense_dir": os.path.join(tmp, "aot_dense", "predict"),
            "out": os.path.join(tmp, "traced_aot.json")}
    with open(os.path.join(tmp, "traced_aot_spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.abspath(__file__)
    with ThreadPoolExecutor(1) as pool:
        beside_result = pool.submit(beside)
        run = subprocess.run([sys.executable, here, "--traced-aot",
                              os.path.join(tmp, "traced_aot_spec.json")],
                             capture_output=True, text=True,
                             timeout=AOT_START_TIMEOUT_S,
                             cwd=os.path.dirname(here))
        beside_result = beside_result.result()
    if run.returncode != 0:
        raise AssertionError(f"serve_aot loaded artifacts: rc "
                             f"{run.returncode}: {run.stderr[-3000:]}")
    with open(spec["out"]) as f:
        traced = json.load(f)
    for name, kernel in (("classifier", "ternary_matmul"),
                         ("retrieval", "ternary_matmul"),
                         ("dense_predict", None)):
        t = traced[name]
        got = t["launches"] if kernel is None else t["launches"].get(kernel)
        if got != t["want"] or t["events"][-1] != t["want"] \
                or any(t.get("failures", [])):
            raise AssertionError(f"serve_aot {name}: launches "
                                 f"{t['launches']}, events {t['events']}, "
                                 f"expected {t['want']}")
    logits = np.asarray(traced["classifier"]["answers"], np.float32)
    np.testing.assert_allclose(logits, clf_ref, rtol=1e-4, atol=1e-4,
                               err_msg="serve_aot classifier vs CPU")
    img, txt = (np.asarray(a, np.float32)
                for a in traced["retrieval"]["answers"])
    for what, got, want in (("image", img, ret_ref["image"]),
                            ("text", txt, ret_ref["text"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=RETRIEVAL_ATOL,
                                   err_msg=f"serve_aot {what} vs CPU")
    emit({"phase": "serve_aot",
          "seconds_to_first_answer": cold, "aot": aot_lines,
          "card": _smi(),
          "classifier": {k: traced["classifier"][k]
                         for k in ("batches", "launches", "events")},
          "retrieval": {k: traced["retrieval"][k]
                        for k in ("batches", "launches", "events")},
          "dense_predict": {k: traced["dense_predict"][k]
                            for k in ("launches", "events")},
          "max_abs_err_vs_cpu": {
              "classifier": float(np.abs(logits - clf_ref).max()),
              "image": float(np.abs(img - ret_ref["image"]).max()),
              "text": float(np.abs(txt - ret_ref["text"]).max())},
          "bit_equal_to_live": traced["bit_equal_to_live"],
          "seconds_by_part": {"processes": processes_s,
                              "loaded_checks": time.perf_counter() - t0
                              - processes_s},
          "seconds": time.perf_counter() - t0})
    total = {}
    for counts in (traced["classifier"]["launches"],
                   traced["retrieval"]["launches"],
                   {"order_stat": traced["dense_predict"]["launches"]}):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, beside_result


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


def _train_run(argv, profile_dir=None):
    """``python -m atq_tpu_torch.train``'s main() with kernel counts reset
    before it and read after it; with ``profile_dir``, ``--profile-dir``
    traces the run's first epoch (and its validation), read back from the
    trace file over the epoch's training steps."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.__main__ import main as train_main

    if profile_dir is not None:
        argv = argv + ["--profile-dir", profile_dir]
    _reset_launches()
    t0 = time.perf_counter()
    _, results = train_main(argv)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    busy = None
    if profile_dir is not None:
        busy = _trace_breakdown(profile_dir, len(results["step_losses"][0]))
    return results, launches, wall, busy


def _trace_events(trace_dir):
    """``(file name, events)`` of the newest trace file under
    ``trace_dir`` (a trainer's ``--profile_dir``)."""
    from atq_tpu_torch.utils.profile_step import (
        latest_trace_file,
        load_events,
    )

    path = latest_trace_file(trace_dir)
    return os.path.basename(path), load_events(path)


def _trace_breakdown(trace_dir, steps, traced=None):
    """The newest trace file under ``trace_dir`` (or ``traced``, its
    :func:`_trace_events`), per training step of its epoch: profile_step's
    step_breakdown of the trainer's ``train_steps`` span, so the
    validation the window also holds is left out (host and device time a
    step, top ops, and the busy share over the span)."""
    from atq_tpu_torch.utils.profile_step import TRAIN_SPAN, step_breakdown

    name, events = traced or _trace_events(trace_dir)
    return {"trace_file": name, "trace_events": len(events),
            **step_breakdown(events, steps, span=TRAIN_SPAN)}


def _profiled_breakdown(prof, steps, seconds, top=8):
    """A finished in-process torch.profiler capture of ``steps`` steps
    that took ``seconds``, read back from its exported Chrome trace by
    profile_step's step_breakdown, with the busy share over ``seconds``.
    Also returns the trace's events."""
    from atq_tpu_torch.utils.profile_step import load_events, step_breakdown

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = load_events(path)
    out = step_breakdown(events, steps, top=top)
    del out["wall_ms"]
    out["share"] = out["device_ms_per_step"] * steps / 1e3 / seconds
    return out, events


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
        results, launches, wall, busy = _train_run(
            argv, profile_dir=os.path.join(tmp, name, "trace"))
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


def _encoder_step0(device, use_amp, attn, hoist, seed=0, forward=None):
    """Loss and every gradient of step 0 of the port's QAT step at
    ENCODER_STEP0 on ``device``, from the ``seed`` init with calibrated
    alphas. ``forward``, a function of plain PyTorch, takes the place of
    the attention kernel's wrapper (a reading or a planted fault); the step
    must call it."""
    from atq_tpu_torch.ops import fused_attention as fa
    from atq_tpu_torch.train.scale import build_step

    step, _, state, _ = build_step(*ENCODER_STEP0, use_amp=use_amp,
                                   attn_impl=attn, hoist_quant=hoist,
                                   device=device, seed=seed)
    _calibrate_alphas(state[0])
    if forward is None:
        state, loss = step(state)
    else:
        calls = [0]

        def counted(*args):
            calls[0] += 1
            return forward(*args)

        with mock.patch.object(fa, "fused_attention_forward", counted):
            state, loss = step(state)
        if not calls[0]:
            raise AssertionError("encoder step 0: the swapped attention "
                                 "forward was never called")
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu() for n, p in state[0].named_parameters()}
    return float(loss), grads


def _forward_f64(q, k, v, scale, bias=None):
    """The attention forward in float64 (_attn_f64), rounded to q's type."""
    return _attn_f64(q, k, v, scale, bias)[0].to(q.dtype)


def _forward_one_tf32_pass(q, k, v, scale, bias=None):
    """A planted fault: the attention forward with one TF32 pass a product
    (_attn_f64's control) where the kernel takes three."""
    return _attn_f64(q, k, v, scale, bias, one_tf32_pass=True)[0].to(q.dtype)


def _forward_bf16(q, k, v, scale, bias=None):
    """A planted fault: the attention in bfloat16 (the plain version on q,
    k and v rounded to bfloat16), as if the projections' float32 bias no
    longer promoted them under AMP; o back in q's type."""
    from atq_tpu_torch.ops.fused_attention import forward_plain

    return forward_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale,
                         bias).to(q.dtype)


def _step0_diffs(got, want):
    """got's distance from want: the loss's relative difference, and the
    largest gradient difference over the largest |gradient| of want, on
    the α leaves (one element a layer) and on the others, each with its
    leaf."""
    top = max(g.abs().max().item() for g in want[1].values())
    worst = {"alpha": (0.0, None), "other": (0.0, None)}
    for name, g in want[1].items():
        kind = "alpha" if name.endswith(".alpha") else "other"
        err = (got[1][name] - g).abs().max().item() / top
        if err > worst[kind][0]:
            worst[kind] = (err, name)
    return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "alpha": worst["alpha"], "other": worst["other"],
            "grad_max": top}


def _compare_encoder(what, got, want, loss_rtol, rtol, atol, alpha_atol=None):
    """Raises past the tolerances (atol relative to the largest |gradient|;
    ``alpha_atol``, when given, in its place on the α leaves); returns
    _step0_diffs."""
    diffs = _step0_diffs(got, want)
    if diffs["loss_rel"] > loss_rtol:
        raise AssertionError(f"{what}: loss {got[0]} vs {want[0]}")
    for name, g in want[1].items():
        a = alpha_atol if alpha_atol and name.endswith(".alpha") else atol
        torch.testing.assert_close(got[1][name], g, rtol=rtol,
                                   atol=a * diffs["grad_max"],
                                   msg=lambda m: f"{what} grad {name}: {m}")
    return {"loss": [got[0], want[0]], **diffs}


def _must_fail(what, got, want, *limits):
    """A planted fault's distance from want: it must fail _compare_encoder
    at ``limits``, so that the check tells it from a correct step."""
    try:
        _compare_encoder(what, got, want, *limits)
    except AssertionError as e:
        return {**_step0_diffs(got, want), "fails": str(e).splitlines()[0]}
    raise AssertionError(f"{what} meets the limits: the check cannot tell it")


def _enter_tree(tree, flag):
    """Makes ``tree`` (a checkout) the working directory and imports its
    atq_tpu_torch; fails if another was imported (the process must not
    have imported one before). Returns the tree's absolute path."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import atq_tpu_torch

    if not os.path.abspath(atq_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"{flag} {tree} imported "
                             f"{atq_tpu_torch.__file__}")
    return tree


def encoder_step0_readings(out, tree="."):
    """The readings behind encoder_step0's limits, from ``tree``'s package
    (run it in a process that has not imported atq_tpu_torch), at each of
    ENCODER_STEP0_SEEDS. Under AMP, against einsum+unhoisted (the phase's
    reference) and against the float32 einsum step on the card: fused+
    hoisted as it ships, with the attention forward swapped for its plain
    version and for float64 (correct forwards), for one TF32 pass a
    product and for the attention in bfloat16 (planted faults). In float32,
    against the CPU's plain step: fused+hoisted as it ships and with one
    TF32 pass. Each with _step0_diffs and the phase's verdict. JSON in
    ``out``."""
    out = os.path.abspath(out)
    tree = _enter_tree(tree, "--encoder-step0")
    from atq_tpu_torch.ops.fused_attention import forward_plain
    from atq_tpu_torch.utils.platform import resolve_device

    resolve_device("cuda")
    amp_variants = {"fused_hoist": None, "plain_forward": forward_plain,
                    "float64_forward": _forward_f64,
                    "fault_one_tf32_pass": _forward_one_tf32_pass,
                    "fault_bf16": _forward_bf16}
    f32_variants = {"fused_hoist": None,
                    "fault_one_tf32_pass": _forward_one_tf32_pass}
    limits = {"amp": (AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_GRAD_ATOL,
                      AMP_ALPHA_ATOL),
              "f32": (STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL)}
    readings = {"tree": tree, "config": ENCODER_STEP0, "limits": limits,
                "seeds": {}}

    def verdict(what, got, want, kind):
        try:
            _compare_encoder(what, got, want, *limits[kind])
            return "pass"
        except AssertionError as e:
            return str(e).splitlines()[0]

    for seed in ENCODER_STEP0_SEEDS:
        amp_ref = _encoder_step0("cuda", True, "einsum", False, seed)
        f32_ref = _encoder_step0("cuda", False, "einsum", False, seed)
        cpu = _encoder_step0("cpu", False, "fused", True, seed)
        row = {"amp_ref_vs_f32": _step0_diffs(amp_ref, f32_ref),
               "f32_ref_vs_cpu": _step0_diffs(f32_ref, cpu)}
        for name, forward in amp_variants.items():
            run = _encoder_step0("cuda", True, "fused", True, seed, forward)
            row["amp_" + name] = {**_step0_diffs(run, amp_ref),
                                  "vs_f32": _step0_diffs(run, f32_ref),
                                  "verdict": verdict(name, run, amp_ref,
                                                     "amp")}
        for name, forward in f32_variants.items():
            run = _encoder_step0("cuda", False, "fused", True, seed, forward)
            row["f32_" + name] = {**_step0_diffs(run, cpu),
                                  "verdict": verdict(name, run, cpu, "f32")}
        readings["seeds"][seed] = row
        emit({"seed": seed, **row})
    with open(out, "w") as f:
        json.dump(readings, f, indent=1)


def phase_encoder_step0():
    """Step 0 at bert-base widths (2 layers, batch 8, sequence 256):
    fused+hoisted on the card against the CPU's plain versions in float32,
    then fused+hoisted against einsum+unhoisted on the card under AMP;
    each with a planted fault in the attention forward that must fail its
    comparison (one TF32 pass a product in float32, the attention in
    bfloat16 under AMP)."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.utils.flops import counted_flops

    t0 = time.perf_counter()
    f32_limits = (STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL)
    amp_limits = (AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_GRAD_ATOL, AMP_ALPHA_ATOL)
    cpu_flops, cpu = counted_flops(
        lambda: _encoder_step0("cpu", False, "fused", True))
    _reset_launches()
    card_flops, card = counted_flops(
        lambda: _encoder_step0("cuda", False, "fused", True))
    launches = kernel_launches()
    for k in ENCODER_PER_STEP:
        if not launches[k]:
            raise AssertionError(f"encoder step 0: {k} never launched")
    # The kernels' own FLOP counts make the card's count the CPU's, where
    # FlopCounterMode sees every plain version's products itself.
    if card_flops["total"] != cpu_flops["total"] or \
            not card_flops["kernels"]["fused_attention_fwd"]:
        raise AssertionError(f"encoder step 0 counted FLOPs: card "
                             f"{card_flops}, cpu {cpu_flops}")
    f32 = _compare_encoder("encoder step 0 card vs cpu", card, cpu,
                           *f32_limits)
    f32_fault = _must_fail(
        "encoder step 0 card vs cpu, one TF32 pass",
        _encoder_step0("cuda", False, "fused", True,
                       forward=_forward_one_tf32_pass), cpu, *f32_limits)
    amp_einsum = _encoder_step0("cuda", True, "einsum", False)
    amp = _compare_encoder(
        "encoder step 0 fused+hoist vs einsum (AMP)",
        _encoder_step0("cuda", True, "fused", True), amp_einsum, *amp_limits)
    amp_fault = _must_fail(
        "encoder step 0 fused+hoist vs einsum (AMP), bfloat16 attention",
        _encoder_step0("cuda", True, "fused", True, forward=_forward_bf16),
        amp_einsum, *amp_limits)
    emit({"phase": "encoder_step0", "config": ENCODER_STEP0,
          "card_vs_cpu_f32": f32, "fault_one_tf32_pass_f32": f32_fault,
          "fused_hoist_vs_einsum_amp": amp, "fault_bf16_amp": amp_fault,
          "launches_card_f32": launches,
          "counted_flops": {"card": card_flops, "cpu": cpu_flops},
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
    from atq_tpu_torch.utils.profile_step import DEVICE_CATEGORIES

    breakdown, events = _profiled_breakdown(prof, steps, wall, top=12)
    attention = {name: sum(e["dur"] for e in events
                           if e.get("cat") in DEVICE_CATEGORIES
                           and name in e.get("name", "")) / 1e3 / steps
                 for name in ("attn_fwd_kernel", "attn_bwd_rows_kernel",
                              "attn_bwd_keys_kernel")}
    return {"build_s": build_s, "traced_steps": steps, "wall_s": wall,
            "busy_share": breakdown.pop("share"),
            "attention_device_ms_per_step": attention, **breakdown}


def encoder_run():
    """One ``python -m atq_tpu_torch.train.scale --configs bert-base --attn
    fused --hoist`` run (its main(): 2 warm-up and 8 timed steps) and a
    traced pair of steps (_trace_encoder), with the imported package."""
    from atq_tpu_torch.train.scale import main as scale_main

    with tempfile.TemporaryDirectory() as tmp:
        row = scale_main(ENCODER_ARGV + ["--out",
                                         os.path.join(tmp, "scale.json")])[0]
    if "error" in row:
        raise AssertionError(f"encoder run: {row['error']}")
    trace = _trace_encoder()
    return {**{k: row[k] for k in ("ms_per_step", "tokens_per_sec",
                                   "mfu_pct")},
            "traced_device_ms_per_step": trace["device_ms_per_step"],
            "traced_busy_share": trace["busy_share"],
            "attention_device_ms_per_step":
                trace["attention_device_ms_per_step"]}


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
                                 "flops_per_step", "flops_per_step_counted",
                                 "flops_per_step_counted_kernels", "losses",
                                 "launches_per_step", "device")},
          "launches": launches, "trace": trace})
    return launches


# The README's retrieval recipe (README.md: train_multimodal.py's flags)
# for 2 epochs on a synthetic corpus of 200 images: 800 training pairs,
# 50 steps an epoch (the depth cut from the default 400 images to keep the
# script's run short; the vocabulary is the same 40 words).
RETRIEVAL_STEPS = 50
RETRIEVAL_TRAIN_ARGV = ["--batch_size", "16", "--embed_dim", "192",
                        "--hidden_dim", "384", "--learning_rate", "5e-5",
                        "--image_size", "160", "--use_residual",
                        "--reinit_model", "--gradual_quant",
                        "--warmup_epochs", "2", "--contrastive_reg", "0.05",
                        "--epochs", "2", "--synthetic_images", "200"]
RETRIEVAL_BATCH = 16
# The fused kernels at the retrieval step's shapes, (M, N, K): the text
# tower's FFN (800 = 16 x 50 tokens; 192 -> 384, 384 -> 192), q/k/v/out,
# attention_pool_0 and attention_pool_2 (N = 1), then the image and text
# projectors (M = 16).
RETRIEVAL_FUSED_SHAPES = ((800, 384, 192), (800, 192, 384), (800, 192, 192),
                          (800, 96, 192), (800, 1, 96), (16, 192, 512),
                          (16, 192, 192))
# Retrieval step 0 runs at each ternary layer's optimal alpha, as
# encoder_step0 does: after --reinit_model every alpha is 1, every ternary
# weight is ±1 and the text tower's attention softmax is near an argmax;
# there every float32 step (card dense, card fused, CPU) is 2.6e-3 to
# 9.1e-3 of the largest gradient from float64 (`--retrieval-step0`).
# Tolerances (readings at optimal alphas on one H100 80GB HBM3 at 700 W,
# `--retrieval-step0`, in brackets): the loss within 1e-5 relative and the
# embeddings within 1e-5. The gradients: every element within
# RET_GRAD_TOL_* of the model's largest |gradient| and the whole within it
# in L2 norm, 1e-2 for the card against the CPU (2.2e-3, 2.7e-3) and 1e-5
# for ATQ_FUSED=1 against dense (2.2e-6, 2.7e-6); and each leaf within
# RET_LEAF_TOL_* of its own L2 norm, by `_leaf_group`. The card against
# the CPU: ResNet-18's leaves 2e-2 (4.5e-3; the CPU against itself at 1
# and 8 threads 9.6e-3: train-mode BatchNorm over 16 images cancels most
# of a convolution's gradient), one-element leaves 2e-2 (4.6e-3, an
# alpha: a sum over a whole layer), other leaves 2e-3 (2.7e-4; a gradient
# 1 % off in one leaf reads 1.0e-2). Fused against dense: 1e-4 for every
# leaf (9.8e-6; the dense step against itself 5.7e-6). A leaf whose
# reference gradient is at most RET_ROUNDING of the model's largest is
# zero to rounding (a bias added to every key or every pooling score, a
# scale that the L2 normalisation removes): not held, but it must stay
# below RET_ROUNDING_GOT of the compared step's largest.
RET_LOSS_RTOL, RET_EMBED_ATOL = 1e-5, 1e-5
RET_GRAD_TOL_CPU, RET_GRAD_TOL_FUSED = 1e-2, 1e-5
RET_LEAF_TOL_CPU = {"trunk": 2e-2, "scalar": 2e-2, "tensor": 2e-3}
RET_LEAF_TOL_FUSED = {"trunk": 1e-4, "scalar": 1e-4, "tensor": 1e-4}
RET_ROUNDING, RET_ROUNDING_GOT = 1e-6, 1e-5
SERVE_EMBED_ATOL = 1e-5  # the served best_model.npz against the trainer
RETRIEVAL_ARTIFACTS = ("best_model.npz", "checkpoint_epoch_2.npz",
                       "final_model.npz", "final_report.json",
                       "metrics.jsonl", "training_history.json",
                       "vocab.json")


def _retrieval_path_layers(model):
    """``(quantized layers on the embedding path, those of them with
    16,384+ weights)``: the image encoder's projector and the text tower
    with its projector. The fused kernels run once per layer and
    direction; the order statistic once per large layer."""
    from atq_tpu_torch.nn.layers import _QuantizedLinear

    layers = [m for name, m in model.named_modules()
              if isinstance(m, _QuantizedLinear) and name.split(".")[0] in
              ("image_encoder", "text_encoder", "text_projector")]
    return len(layers), sum(m.weight.numel() >= 16384 for m in layers)


def _retrieval_step0_setup(tmp, optimal_alphas=True, amp=False, dropout=0.0,
                           n=RETRIEVAL_BATCH, raw_uint8=False,
                           moe_experts=0, seed=0):
    """The README-width model on the CPU with ``dropout`` (0 by default),
    after --reinit_model and epoch 0 of the gradual schedule, at optimal
    alphas (or at the recipe's alpha 1), with ``compute_dtype=bfloat16``
    when ``amp`` (the same weights), with ``moe_experts`` experts a text
    layer (and the config's aux term) when above 0, and the first ``n``
    synthetic training pairs as float images (normalized, unflipped), or as
    uint8 images when ``raw_uint8``; the init from ``seed`` (the reinit
    from 99 + ``seed``)."""
    from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
    from atq_tpu_torch.core.schedules import GradualQuantizationScheduler
    from atq_tpu_torch.data.flickr8k import Flickr8kDataset
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.nn.layers import _QuantizedLinear
    from atq_tpu_torch.train.retrieval import (
        RetrievalConfig,
        reinit_model_,
        retrieval_sparsity_plan,
    )

    ds = Flickr8kDataset(os.path.join(tmp, "no_flickr8k"), "train",
                         image_size=IMAGE_SIZE, max_length=SEQ_LEN,
                         raw_uint8=raw_uint8)
    images, ids, lengths = zip(*(ds[i] for i in range(n)))
    batch = (np.stack(images) if raw_uint8
             else np.stack(images).astype(np.float32), np.stack(ids),
             np.asarray(lengths, np.int32))
    cfg = RetrievalConfig(use_residual=True, reinit_model=True,
                          gradual_quant=True, warmup_epochs=2,
                          contrastive_reg=0.05, epochs=2,
                          moe_experts=moe_experts)
    model = ATQMultimodalRetrieval(
        vocab_size=ds.vocab_size, embed_dim=192, hidden_dim=384,
        use_residual=True, max_seq_length=SEQ_LEN, dropout=dropout,
        text_moe_experts=moe_experts,
        compute_dtype=torch.bfloat16 if amp else None, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    reinit_model_(model, torch.Generator().manual_seed(99 + seed))
    GradualQuantizationScheduler(2, warmup_epochs=2).step(
        model, 0, retrieval_sparsity_plan(cfg))
    if not optimal_alphas:
        return model, batch, cfg
    with torch.no_grad():  # each ternary layer at its optimal alpha
        for mod in model.modules():
            if isinstance(mod, _QuantizedLinear):
                _, alpha = adaptive_ternary_quantization(
                    mod.weight, sparsity_target=mod.sparsity_target)
                mod.alpha.fill_(float(alpha))
    return model, batch, cfg


@contextlib.contextmanager
def _float64_forward():
    """Tensor.float() keeps float64 tensors as they are, so a float64 copy
    of the model runs in float64 throughout (the port computes its
    LayerNorms and softmaxes in float32 whatever the input)."""
    to_float = torch.Tensor.float
    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else to_float(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def _retrieval_step0(model, batch, cfg, device, fused, dtype=torch.float32):
    """Loss, embeddings, every gradient and the kernel launches of one
    retrieval train step (no update) of a copy of ``model`` on
    ``device``; ``fused`` sets ATQ_FUSED=1; ``dtype`` float64 runs the
    copy in float64 (on the CPU)."""
    import copy

    from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import (
        _batch_to,
        build_retrieval_train_step,
    )

    dev = torch.device(device)
    m = copy.deepcopy(model).to(dev, dtype)
    criterion = HardNegativeMiningInfoNCE(lambda_reg=cfg.contrastive_reg)
    criterion.set_epoch(0, cfg.epochs)
    b = _batch_to(batch, dev)
    b = (b[0].to(dtype),) + tuple(b[1:])
    os.environ["ATQ_FUSED"] = "1" if fused else "0"
    with (_float64_forward() if dtype == torch.float64
          else contextlib.nullcontext()):
        try:
            _reset_launches()
            loss = build_retrieval_train_step(m, _NoUpdate(), criterion,
                                              cfg)(
                b, torch.tensor(criterion.get_current_temperature(),
                                device=dev, dtype=dtype),
                torch.tensor(0, device=dev))
            launches = kernel_launches()
            with torch.no_grad():  # train mode again: the step's embeddings
                img, txt = m(*b, return_embeddings=True, train=True)
        finally:
            os.environ["ATQ_FUSED"] = "0"
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().double().cpu() for n, p in m.named_parameters()}
    return (float(loss), img.double().cpu(), txt.double().cpu(), grads,
            launches)


def _leaf_group(name, grad):
    """``trunk`` (ResNet-18's float convolutions and BatchNorms),
    ``scalar`` (one-element leaves: alphas, gates, the temperature) or
    ``tensor`` (the projectors, the text tower and the rest)."""
    if name.startswith("image_encoder.base_model."):
        return "trunk"
    return "scalar" if grad.numel() == 1 else "tensor"


def _compare_retrieval_step0(what, got, want, grad_tol=None, leaf_tol=None,
                             per_leaf=False):
    """The loss's relative difference, the embeddings' largest difference,
    the gradients against the model's largest |gradient| (elementwise) and
    in L2 over the model, and leaf by leaf the L2 difference over the
    leaf's L2 norm (the worst leaf of each ``_leaf_group``), leaving out
    the leaves zero to rounding (RET_ROUNDING); ``per_leaf`` adds every
    leaf's reading and its largest |difference| over its largest
    |gradient|. With ``grad_tol`` and ``leaf_tol`` (a limit per group),
    raises past them, past the loss and embedding tolerances, or when a
    leaf zero to rounding in ``want`` is past RET_ROUNDING_GOT in
    ``got``."""
    rel = abs(got[0] - want[0]) / abs(want[0])
    emb = max((a - b).abs().max().item() for a, b in zip(got[1:3],
                                                         want[1:3]))
    gmax = {n: g.abs().max().item() for n, g in want[3].items()}
    scale = max(gmax.values())
    got_scale = max(g.abs().max().item() for g in got[3].values())
    el = max((got[3][n] - g).abs().max().item()
             for n, g in want[3].items()) / scale
    l2 = (sum(((got[3][n] - g) ** 2).sum().item()
              for n, g in want[3].items())
          / sum((g ** 2).sum().item() for g in want[3].values())) ** 0.5
    rounding = sorted(n for n, m in gmax.items()
                      if m <= RET_ROUNDING * scale)
    rounding_got = max((got[3][n].abs().max().item() / got_scale
                        for n in rounding), default=0.0)
    leaf_l2, worst = {}, {}
    for n, g in want[3].items():
        if n not in rounding:
            leaf_l2[n] = ((got[3][n] - g).norm() / g.norm()).item()
            group = _leaf_group(n, g)
            if leaf_l2[n] >= worst.get(group, ("", -1.0))[1]:
                worst[group] = (n, leaf_l2[n])
    out = {"loss": got[0], "loss_rel_diff": rel,
           "embedding_max_abs_diff": emb, "grad_max": scale,
           "grad_max_abs_diff_over_max": el, "grad_l2_rel_diff": l2,
           "leaf_l2_rel_diff": worst,
           "rounding_leaves": [n for n in rounding if gmax[n] > 0],
           "zero_leaves": sum(gmax[n] == 0 for n in rounding),
           "rounding_leaves_got_over_max": rounding_got,
           "grad_leaves": len(want[3])}
    if per_leaf:
        out["leaves"] = {n: [(got[3][n] - want[3][n]).abs().max().item()
                             / gmax[n], v] for n, v in leaf_l2.items()}
    if grad_tol is not None and (
            rel > RET_LOSS_RTOL or emb > RET_EMBED_ATOL or el > grad_tol
            or l2 > grad_tol or rounding_got > RET_ROUNDING_GOT
            or any(v > leaf_tol[g] for g, (_, v) in worst.items())):
        raise AssertionError(f"{what} step 0 past its tolerances (loss "
                             f"{RET_LOSS_RTOL}, embeddings "
                             f"{RET_EMBED_ATOL}, gradients {grad_tol}, "
                             f"each leaf {leaf_tol}, rounding leaves "
                             f"{RET_ROUNDING_GOT}): {json.dumps(out)}")
    return out


def _planted(result, fault):
    """``result`` (a step-0 reading) with a fault planted in its
    gradients: ``alpha`` drops every dα, ``text_projector`` scales the
    text projector's weight gradient by 1.01, ``layer_norm`` scales one
    text layer's norm2 scale gradient by 1.01."""
    grads, hit = dict(result[3]), 0
    for n in grads:
        if ((fault == "alpha" and n.endswith(".alpha"))
                or (fault == "text_projector"
                    and n == "text_projector.weight")
                or (fault == "layer_norm"
                    and n == "text_encoder.layers_1.norm2.weight")):
            grads[n] = torch.zeros_like(grads[n]) if fault == "alpha" \
                else grads[n] * 1.01
            hit += 1
    if not hit:
        raise AssertionError(f"planted fault {fault}: no such leaf")
    return result[:3] + (grads,) + result[4:]


def _check_launches(what, got, want):
    for kernel, n in got.items():
        if n != want.get(kernel, 0):
            raise AssertionError(f"{what}: {kernel} {n} launches per step, "
                                 f"expected {want.get(kernel, 0)}")


def phase_train_retrieval(tmp):
    """The retrieval slice on the card: the fused kernels at the step's
    shapes; step 0 card against CPU and ATQ_FUSED=1 against dense; 2
    epochs of ``python -m atq_tpu_torch.train.retrieval``'s main() on the
    README recipe (counts reset before it and read after it, epoch 1
    traced by ``--profile_dir``); then best_model.npz served by a fresh
    model."""
    from atq_tpu_torch.data.flickr8k import Flickr8kDataset, load_vocab_file
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import (
        _batch_to,
        build_embed_fn,
        main as retrieval_main,
    )
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    t0 = time.perf_counter()
    errs, f64, da_rel, cases = check_fused(
        torch.Generator(device="cuda").manual_seed(12),
        RETRIEVAL_FUSED_SHAPES)
    fused_check = {"shapes": RETRIEVAL_FUSED_SHAPES, "max_abs_err": errs,
                   "f64_rel_err": {k: v["kernel"] for k, v in f64.items()},
                   "dalpha_max_rel_err": da_rel, "cases": cases}

    model, batch, cfg = _retrieval_step0_setup(tmp)
    n_layers, n_large = _retrieval_path_layers(model)
    dense_launches = {"order_stat": n_large}
    fused_launches = {"order_stat": n_large, "fused_forward": n_layers,
                      "fused_dx": n_layers, "fused_dwda": n_layers}
    cpu = _retrieval_step0(model, batch, cfg, "cpu", False)
    dense = _retrieval_step0(model, batch, cfg, "cuda", False)
    _check_launches("retrieval step 0 dense", dense[4], dense_launches)
    fused = _retrieval_step0(model, batch, cfg, "cuda", True)
    _check_launches("retrieval step 0 fused", fused[4], fused_launches)
    step0 = {"vs_cpu": _compare_retrieval_step0(
                 "dense", dense, cpu, RET_GRAD_TOL_CPU, RET_LEAF_TOL_CPU),
             "fused_vs_dense": _compare_retrieval_step0(
                 "fused", fused, dense, RET_GRAD_TOL_FUSED,
                 RET_LEAF_TOL_FUSED),
             "launches_dense": dense[4], "launches_fused": fused[4]}
    del model, cpu, dense, fused
    step0_s = time.perf_counter() - t0

    out_dir = os.path.join(tmp, "retrieval_train")
    trace_dir = os.path.join(tmp, "retrieval_trace")
    argv = RETRIEVAL_TRAIN_ARGV + ["--output_dir", out_dir, "--data_dir",
                                   os.path.join(tmp, "no_flickr8k"),
                                   "--profile_dir", trace_dir]
    _reset_launches()
    t1 = time.perf_counter()
    state, history, report = retrieval_main(argv)
    wall = time.perf_counter() - t1
    launches = kernel_launches()
    stats = state["stats"]
    losses = [x for epoch in stats["step_losses"] for x in epoch]
    if len(losses) != 2 * RETRIEVAL_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train_retrieval: {len(losses)} step losses, "
                             f"finite: {np.isfinite(losses).all()}")
    for epoch, per_step in enumerate(stats["launches_per_step"]):
        _check_launches(f"train_retrieval epoch {epoch}", per_step,
                        dense_launches)
    recalls = {"val": [{f"mean_R@{k}": m[f"mean_R@{k}"] for k in (1, 5, 10)}
                       for m in history["val_metrics"]],
               "test": {f"mean_R@{k}": report["test_metrics"][f"mean_R@{k}"]
                        for k in (1, 5, 10)}}
    if not np.isfinite([v for m in recalls["val"] + [recalls["test"]]
                        for v in m.values()]).all():
        raise AssertionError(f"train_retrieval: recalls {recalls}")
    artifacts = sorted(os.listdir(out_dir))
    missing = [f for f in RETRIEVAL_ARTIFACTS if f not in artifacts]
    if missing:
        raise AssertionError(f"train_retrieval: missing {missing}")
    busy = _trace_breakdown(trace_dir, len(stats["step_losses"][0]))

    # best_model.npz served by a fresh model against the trainer's
    # embedding function (whose model holds best_model.npz after the run).
    vocab = load_vocab_file(os.path.join(out_dir, "vocab.json"))
    served = ATQMultimodalRetrieval(vocab_size=len(vocab), embed_dim=192,
                                    hidden_dim=384, use_residual=True,
                                    max_seq_length=SEQ_LEN, device="cuda")
    served.load_jax_variables(load_checkpoint(
        os.path.join(out_dir, "best_model.npz")))
    val = Flickr8kDataset(os.path.join(tmp, "no_flickr8k"), "val",
                          image_size=IMAGE_SIZE, max_length=SEQ_LEN,
                          vocab=vocab, raw_uint8=True)
    images, ids, lengths = zip(*(val[i] for i in range(RETRIEVAL_BATCH)))
    b = _batch_to((np.stack(images), np.stack(ids),
                   np.asarray(lengths, np.int32)), torch.device("cuda"))
    want = state["embed_fn"](b)
    got = build_embed_fn(served)(b)
    serve_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if serve_err > SERVE_EMBED_ATOL:
        raise AssertionError(f"served best_model.npz: {serve_err}")

    emit({"phase": "train_retrieval", "argv": RETRIEVAL_TRAIN_ARGV,
          "fused_kernels": fused_check, "step0": step0,
          "step0_seconds": step0_s, "wall_s": wall,
          "steps_per_epoch": len(stats["step_losses"][0]),
          "pairs_per_s": stats["pairs_per_sec"],
          "step_ms_p50": [float(np.percentile(t, 50))
                          for t in stats["step_ms"]],
          "epoch_seconds": stats["epoch_seconds"],
          "launches_per_step": stats["launches_per_step"],
          "launches": launches, "traced_epoch": busy,
          "loss_first_step": losses[0], "loss_last_step": losses[-1],
          "train_losses": history["train_losses"], "recalls": recalls,
          "atq_inference_time_ms": report["atq_inference_time_ms"],
          "artifacts": artifacts, "served_max_abs_diff": serve_err})
    return launches


# Scanned against unrolled step 0 (train_retrieval_scan): the same weights,
# the text tower as ``layers_{i}`` or as the stacked ``layers.scan.layer``
# (each layer rematerialized; dense, quantized outside its checkpoint;
# under ATQ_FUSED=1, the fused kernels inside it on a threshold computed
# outside). Readings (--retrieval-scan-step0 and the phase's line; one
# H100 80GB HBM3 at 700 W), dense and fused alike: the two run the same
# operations in the same order, so loss, embeddings and every gradient
# leaf off ResNet-18's trunk equal bit for bit; the trunk's leaves differ
# by up to 5.6e-6 of a leaf's L2 norm, as the unrolled step differs from
# itself run again (5.6e-6: cuDNN's filter gradients sum in no fixed
# order). So both modes are held bit for bit off the trunk and, everywhere,
# within train_retrieval's fused-vs-dense limits (RET_GRAD_TOL_FUSED,
# RET_LEAF_TOL_FUSED). The planted fault reads 0.32 of the largest
# gradient in both modes.
SCAN_LAYERS = 4


def _scanned_copy(model):
    """``model`` (README widths, on the CPU) with its text tower as the
    ScannedTernaryStack on the same weights."""
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.nn.transformer import stack_layer_params

    te = model.text_encoder
    scanned = ATQMultimodalRetrieval(
        vocab_size=te.embedding.num_embeddings, embed_dim=192,
        hidden_dim=384, use_residual=True, max_seq_length=SEQ_LEN,
        dropout=0.0, text_scan_layers=True, device="cpu")
    scanned.load_state_dict(stack_layer_params(
        model.state_dict(), SCAN_LAYERS, prefix="text_encoder.layers_",
        dest="text_encoder.layers"))
    return scanned


def _unstacked(result):
    """A scanned step-0 result with its gradients under the unrolled
    names."""
    from atq_tpu_torch.nn.transformer import unstack_layer_params

    return result[:3] + (unstack_layer_params(
        result[3], SCAN_LAYERS, prefix="text_encoder.layers_",
        dest="text_encoder.layers"),) + result[4:]


def _bit_equal(got, want, trunk=True):
    """Loss, embeddings and every gradient leaf (with ``trunk``, ResNet-18's
    too) equal bit for bit."""
    return (got[0] == want[0] and all(torch.equal(a, b) for a, b in
                                      zip(got[1:3], want[1:3]))
            and sorted(got[3]) == sorted(want[3])
            and all(torch.equal(got[3][n], g) for n, g in want[3].items()
                    if trunk or _leaf_group(n, g) != "trunk"))


def _swapped_layers(scanned):
    """A planted fault: layers 1 and 2 of the stacked FFN weight
    (``linear1``) swapped."""
    import copy

    bad = copy.deepcopy(scanned)
    w = bad.text_encoder.layers.scan.layer.linear1.weight
    with torch.no_grad():
        w[[1, 2]] = w[[2, 1]].clone()
    return bad


def scan_step0_readings(tmp):
    """Step 0 of the README model at optimal alphas on the card, dense and
    under ATQ_FUSED=1: the unrolled model twice and the scanned one, and
    the scanned one with a planted fault (:func:`_swapped_layers`), each
    pair's readings (train_retrieval's) and whether it is equal bit for
    bit; the launches of each step and the path's layers (all, and those
    of 16,384+ weights). Returns ``(readings, results)``, the second the
    step-0 results by mode (unrolled, scanned, fault; unrolled names)."""
    model, batch, cfg = _retrieval_step0_setup(tmp)
    scanned = _scanned_copy(model)
    bad = _swapped_layers(scanned)
    readings = {"path_layers": _retrieval_path_layers(model)}
    results = {}
    for mode, fused in (("dense", False), ("fused", True)):
        unrolled = _retrieval_step0(model, batch, cfg, "cuda", fused)
        again = _retrieval_step0(model, batch, cfg, "cuda", fused)
        scan = _unstacked(_retrieval_step0(scanned, batch, cfg, "cuda",
                                           fused))
        fault = _unstacked(_retrieval_step0(bad, batch, cfg, "cuda", fused))
        results[mode] = (unrolled, scan, fault)
        readings[mode] = {"launches_unrolled": unrolled[4],
                          "launches_scanned": scan[4]}
        for name, got in (("unrolled_again", again), ("scanned", scan),
                          ("fault", fault)):
            readings[mode][name] = {
                "bit_equal": _bit_equal(got, unrolled),
                "bit_equal_off_trunk": _bit_equal(got, unrolled,
                                                  trunk=False),
                **_compare_retrieval_step0(f"{mode} {name}", got, unrolled)}
    return readings, results


def _scan_step0_check(readings, results):
    """The verdicts of train_retrieval_scan (a): the scanned step against
    the unrolled one bit for bit off the trunk and within the fused
    limits; the planted fault past both; raises past them."""
    out = {}
    for mode, (unrolled, scan, fault) in results.items():
        r = readings[mode]
        if not r["scanned"]["bit_equal_off_trunk"]:
            raise AssertionError(f"scanned step 0 ({mode}) is not the "
                                 f"unrolled one bit for bit off the trunk: "
                                 f"{json.dumps(r['scanned'])}")
        _compare_retrieval_step0(f"scanned step 0 ({mode})", scan, unrolled,
                                 RET_GRAD_TOL_FUSED, RET_LEAF_TOL_FUSED)
        if r["fault"]["bit_equal_off_trunk"]:
            raise AssertionError(f"planted fault ({mode}) equals the "
                                 f"unrolled step")
        try:
            _compare_retrieval_step0(f"planted fault ({mode})", fault,
                                     unrolled, RET_GRAD_TOL_FUSED,
                                     RET_LEAF_TOL_FUSED)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"planted fault ({mode}) meets the fused "
                                 f"limits: the check cannot tell it")
        out[mode] = {**r, "held": "bit for bit off the trunk, fused limits"}
    return out


def phase_train_retrieval_scan(tmp):
    """``--scan_layers`` on the card at the README recipe's widths: (a)
    step 0 scanned against unrolled, dense and fused, with a planted
    fault; (b) the recipe trained 2 epochs with ``--scan_layers
    --checkpoint_freq 1``, its ``step_2`` state removed, then epoch 2 again
    with ``--resume --profile_dir``: the trace file read back with
    summarize_trace, its order-statistic kernels counted against the
    launches the trainer counted in the traced window."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import main as retrieval_main
    from atq_tpu_torch.utils.profile_step import (
        DEVICE_CATEGORIES,
        TRAIN_SPAN,
        span_events,
        summarize_trace,
    )

    t0 = time.perf_counter()
    readings, results = scan_step0_readings(tmp)
    n_layers, n_large = readings["path_layers"]
    # Under ATQ_FUSED=1 every path layer runs the fused kernels, and each
    # stacked layer's forward once more in its recompute; the thresholds
    # are computed outside the recompute, once a layer.
    stacked = 6 * SCAN_LAYERS
    want = {"dense": {"order_stat": n_large},
            "fused": {"order_stat": n_large,
                      "fused_forward": n_layers + stacked,
                      "fused_dx": n_layers, "fused_dwda": n_layers}}
    for mode in results:
        _check_launches(f"scanned step 0 ({mode})",
                        readings[mode]["launches_scanned"], want[mode])
    step0 = _scan_step0_check(readings, results)
    del results
    step0_s = time.perf_counter() - t0

    out_dir = os.path.join(tmp, "retrieval_scan")
    trace_dir = os.path.join(tmp, "retrieval_scan_trace")
    argv = RETRIEVAL_TRAIN_ARGV + [
        "--scan_layers", "--checkpoint_freq", "1", "--output_dir", out_dir,
        "--data_dir", os.path.join(tmp, "no_flickr8k")]
    _reset_launches()
    t1 = time.perf_counter()
    state, history, _ = retrieval_main(argv)
    wall = time.perf_counter() - t1
    stats = state["stats"]
    steps = len(stats["step_losses"][0])
    losses = [x for epoch in stats["step_losses"] for x in epoch]
    if len(losses) != 2 * steps or not np.isfinite(losses).all():
        raise AssertionError(f"train_retrieval_scan: {len(losses)} step "
                             f"losses, finite: {np.isfinite(losses).all()}")
    for epoch, per_step in enumerate(stats["launches_per_step"]):
        _check_launches(f"train_retrieval_scan epoch {epoch}", per_step,
                        want["dense"])
    launches = kernel_launches()
    os.remove(os.path.join(out_dir, "orbax", "step_2"))

    _reset_launches()
    t2 = time.perf_counter()
    resumed, resumed_history, _ = retrieval_main(
        argv + ["--resume", "--profile_dir", trace_dir])
    resumed_wall = time.perf_counter() - t2
    rstats = resumed["stats"]
    if len(rstats["step_losses"]) != 1 or \
            len(rstats["step_losses"][0]) != steps:
        raise AssertionError(f"resumed run: epochs {rstats['step_losses']}")
    traced = rstats["profile_launches"]
    counted = traced["order_stat"] + traced["batched_order_stat"]
    trace = _trace_events(trace_dir)
    in_trace = sum("order_stat_cluster_kernel" in e.get("name", "")
                   for e in trace[1] if e.get("cat") in DEVICE_CATEGORIES)
    if in_trace != counted or not counted:
        raise AssertionError(f"traced epoch: {in_trace} "
                             f"order_stat_cluster_kernel events in the "
                             f"trace, {counted} launches counted")
    # The training steps' span holds the epoch's steps' launches and no
    # validation's.
    per_step = rstats["launches_per_step"][0]
    in_steps = round((per_step["order_stat"]
                      + per_step["batched_order_stat"]) * steps)
    in_span = sum("order_stat_cluster_kernel" in e.get("name", "")
                  for e in span_events(trace[1], TRAIN_SPAN)[1])
    if in_span != in_steps:
        raise AssertionError(f"traced epoch's train_steps span: {in_span} "
                             f"order_stat_cluster_kernel events, "
                             f"{in_steps} launches counted in its steps")
    busy = _trace_breakdown(trace_dir, steps, traced=trace)
    del trace
    top = [[o.name, o.total_us / 1e3, o.count, o.pct]
           for o in summarize_trace(trace_dir, top=10)]
    emit({"phase": "train_retrieval_scan",
          "argv": RETRIEVAL_TRAIN_ARGV + ["--scan_layers"],
          "step0": step0, "step0_seconds": step0_s, "wall_s": wall,
          "pairs_per_s": stats["pairs_per_sec"],
          "step_ms_p50": [float(np.percentile(t, 50))
                          for t in stats["step_ms"]],
          "launches_per_step": stats["launches_per_step"],
          "launches": launches, "train_losses": history["train_losses"],
          "resumed": {"wall_s": resumed_wall,
                      "train_losses": resumed_history["train_losses"],
                      "pairs_per_s": rstats["pairs_per_sec"],
                      "traced_window_launches": traced,
                      "order_stat_kernels_in_trace": in_trace,
                      "order_stat_kernels_in_train_steps": in_span,
                      "top10_device_ops": top, "traced_epoch": busy}})
    return traced


def retrieval_step0_readings(tmp):
    """``--retrieval-step0``: the readings behind the retrieval step-0
    limits, at the recipe's alpha 1 and at optimal alphas. The dense step
    on the card, again on the card, with ATQ_FUSED=1, on the CPU at 8 and
    at 1 thread, and in float64 on the CPU; each held against the others
    as the phase holds them, with the phase's verdict at its limits (the
    fused runs at the fused limits, the rest at the CPU's), and the
    planted faults of ``_planted`` in the card's gradients against the
    CPU's."""
    out = {}
    for optimal in (False, True):
        model, batch, cfg = _retrieval_step0_setup(tmp, optimal)
        runs = {"cpu": _retrieval_step0(model, batch, cfg, "cpu", False),
                "f64": _retrieval_step0(model, batch, cfg, "cpu", False,
                                        torch.float64)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            runs["cpu1"] = _retrieval_step0(model, batch, cfg, "cpu", False)
        finally:
            torch.set_num_threads(threads)
        for name, fused in (("dense", False), ("again", False),
                            ("fused", True)):
            runs[name] = _retrieval_step0(model, batch, cfg, "cuda", fused)
        pairs = (("dense", "cpu"), ("fused", "dense"), ("again", "dense"),
                 ("cpu1", "cpu"), ("dense", "f64"), ("fused", "f64"),
                 ("cpu", "f64"))
        cases = {f"{a}_vs_{b}": (runs[a], runs[b]) for a, b in pairs}
        for fault in ("alpha", "text_projector", "layer_norm"):
            cases[f"planted_{fault}_vs_cpu"] = (
                _planted(runs["dense"], fault), runs["cpu"])
        readings = {}
        for name, (got, want) in cases.items():
            readings[name] = _compare_retrieval_step0(name, got, want,
                                                      per_leaf=True)
            limits = ((RET_GRAD_TOL_FUSED, RET_LEAF_TOL_FUSED)
                      if name.startswith("fused") else
                      (RET_GRAD_TOL_CPU, RET_LEAF_TOL_CPU))
            try:  # the phase's verdict on this pair
                _compare_retrieval_step0(name, got, want, *limits)
                readings[name]["within_phase_limits"] = True
            except AssertionError:
                readings[name]["within_phase_limits"] = False
        out["optimal_alphas" if optimal else "alpha_1"] = readings
        emit({"phase": "retrieval_step0_readings",
              "alphas": "optimal" if optimal else "1",
              "cpu_threads": threads,
              **{k: {kk: vv for kk, vv in v.items() if kk != "leaves"}
                 for k, v in readings.items()}})
    return out


# The AMP and GradCache slice of the retrieval trainer (phase
# train_retrieval_amp). Step 0 under --use_amp (compute_dtype bfloat16) has
# the same set-up as train_retrieval's (dropout 0, optimal alphas, the
# first 16 pairs). bf16 roundings do not compare element by element
# between cuDNN and the CPU: a convolution that sums in another order
# flips an output's last bf16 bit now and then. So the card's AMP runs are
# held to their distance from the CPU's AMP runs *relative to* AMP's own
# distance from the CPU's float32 runs, sum|card - cpu_bf16| /
# sum|cpu_bf16 - cpu_f32|, by leaf group (``_leaf_group``) and for the
# embeddings: a card that computes in bf16 where the CPU does reads well
# below 1, one that computes elsewhere (a planted fault: BatchNorm in bf16,
# convolutions left in float32) about 1. Two runs:
# - the train step (train-mode BatchNorm), held coarsely: train-mode
#   BatchNorm over 16 images cancels most of a convolution's gradient, so
#   the flips move its AMP gradients by about AMP's own error (the CPU at 1
#   thread against 8 reads 0.67-0.81) and no limit tells a fault from a
#   correct step there: the card reads 0.45-0.75 (loss 2.9e-3), the faults
#   0.76-1.10 (loss 3.5e-3, 4.1e-3); AMP_STEP_LIMIT;
# - the same model in eval mode (BatchNorm on its running statistics), the
#   embeddings' forward and the backward of <embeddings, fixed
#   cotangents>: the CPU at 1 thread against 8 reads below 3e-5, each
#   module on the CPU's inputs flips 0.001-0.1 % of its bf16 outputs on
#   the card by one bf16 ulp, and those flips, carried through 17
#   convolutions, read 0.73 on the ResNet leaves, 0.89 on the one-element
#   leaves, 0.56 on the other leaves, 0.44 on the embeddings (loss
#   3.0e-3). The planted faults read 0.995 and 1.006 on the ResNet leaves
#   and must fail AMP_EVAL_LIMIT there (its other entries only bound the
#   spread: the faults read 0.52-1.01 on them).
# Readings: `--retrieval-amp-step0` on one H100 80GB HBM3 at 700 W
# (PERF.md §6; the card's runs repeat bit for bit). The train step's ternary
# patterns and thresholds under AMP equal the float32 step's bit for bit
# on the card (the quantizer stays float32), every threshold taken on a
# float32 weight.
AMP_STEP_LIMIT = {"loss_rel_diff": 1e-2, "trunk": 1.5, "scalar": 1.5,
                  "tensor": 1.5, "embeddings": 1.5}
AMP_EVAL_LIMIT = {"loss_rel_diff": 1e-2, "trunk": 0.85, "scalar": 1.2,
                  "tensor": 0.8, "embeddings": 0.8}
AMP_FAULTS = ("bn_bf16", "conv_f32")
# GradCache at --batch_size 64 --grad_accum_steps 4 (microbatches of 16,
# the recipe's activation memory, with a pool 4x larger), dropout 0.1 and
# uint8 images (flips drawn): the step-0 gradients against the
# concatenated-pool oracle (the four microbatches through the model one
# after another with the same generator, one autograd over the full-pool
# loss), and with ATQ_FUSED=1 against the dense GradCache step, each leaf
# within GRADCACHE_ATOL x (1 + its largest |gradient|)
# (tests/test_grad_accum.py:136-141).
GRADCACHE_BATCH, GRADCACHE_N, GRADCACHE_ATOL = 64, 4, 1e-4
RETRIEVAL_AMP_ARGV = ["--batch_size", "64", "--embed_dim", "192",
                      "--hidden_dim", "384", "--learning_rate", "5e-5",
                      "--image_size", "160", "--use_residual",
                      "--reinit_model", "--gradual_quant",
                      "--warmup_epochs", "2", "--contrastive_reg", "0.05",
                      "--epochs", "1", "--use_amp", "--grad_accum_steps",
                      "4"]
# The preemption drill: the recipe for 2 epochs writing its state every
# epoch, killed once orbax/step_1 is committed, then resumed; on 100
# synthetic images (25 steps an epoch), since what it checks does not
# depend on the depth.
DRILL_ARGV = RETRIEVAL_TRAIN_ARGV + ["--checkpoint_freq", "1",
                                     "--synthetic_images", "100"]
DRILL_TIMEOUT_S = 300


@contextlib.contextmanager
def _recorded_quantizer():
    """Records every threshold the quantizer computes (with its weight's
    dtype) and every ternary pattern of a quantized layer."""
    from atq_tpu_torch.core import quantize
    from atq_tpu_torch.nn import layers

    calls = {"thresholds": [], "patterns": []}
    threshold, quantize_fn = quantize.ternary_threshold, layers._quantize

    def rec_threshold(weights, *a, **k):
        t = threshold(weights, *a, **k)
        calls["thresholds"].append((weights.dtype, t.detach().cpu()))
        return t

    def rec_quantize(*a, **k):
        w_t, alpha = quantize_fn(*a, **k)
        calls["patterns"].append(w_t.detach().cpu())
        return w_t, alpha

    with mock.patch.object(quantize, "ternary_threshold", rec_threshold), \
            mock.patch.object(layers, "_quantize", rec_quantize):
        yield calls


@contextlib.contextmanager
def _amp_fault(name):
    """A planted AMP fault: ``bn_bf16`` computes every BatchNorm in bf16,
    ``conv_f32`` leaves the convolutions in float32."""
    from atq_tpu_torch.models import resnet

    if name is None:
        yield
    elif name == "bn_bf16":
        with mock.patch.object(
                resnet._BatchNorm32, "forward",
                lambda self, x: resnet._BatchNorm.forward(
                    self, x.to(torch.bfloat16)).float()):
            yield
    else:
        with mock.patch.object(resnet.Conv, "forward",
                               lambda self, x: torch.nn.Conv2d.forward(
                                   self, x.float())):
            yield


def _amp_ratios(got, amp, f32):
    """The loss's relative difference from ``amp`` and, by leaf group and
    for the embeddings, sum|got - amp| / sum|amp - f32|."""
    sums = {}

    def add(group, g, a, f):
        s = sums.setdefault(group, [0.0, 0.0])
        s[0] += (g - a).abs().sum().item()
        s[1] += (a - f).abs().sum().item()

    for n, a in amp[3].items():
        add(_leaf_group(n, a), got[3][n], a, f32[3][n])
    for i in (1, 2):
        add("embeddings", got[i], amp[i], f32[i])
    return {"loss_rel_diff": abs(got[0] - amp[0]) / abs(amp[0]),
            **{g: d / n for g, (d, n) in sums.items()}}


def _amp_within(r, limits):
    return all(r[k] <= lim for k, lim in limits.items())


def _retrieval_eval_grads(model, batch, device):
    """The eval-mode forward (BatchNorm on its running statistics) and the
    backward of ``<embeddings, fixed cotangents>`` of a copy of ``model``
    on ``device``: (that sum, image and text embeddings, every gradient),
    as :func:`_retrieval_step0`'s first four."""
    import copy

    from atq_tpu_torch.train.retrieval import _batch_to

    dev = torch.device(device)
    m = copy.deepcopy(model).to(dev)
    b = _batch_to(batch, dev)
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn(b[0].shape[0], 192, generator=g).to(dev)
           for _ in range(2)]
    img, txt = m(*b, return_embeddings=True, train=False)
    s = (img.float() * cot[0]).sum() + (txt.float() * cot[1]).sum()
    s.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().double().cpu() for n, p in m.named_parameters()}
    return (s.item(), img.detach().double().cpu(),
            txt.detach().double().cpu(), grads)


def _amp_step0_runs(tmp, cpu_threads=(None,), again=False, faults=()):
    """Step 0 under AMP and in eval mode (:func:`_retrieval_eval_grads`)
    on the CPU (at each of ``cpu_threads``, None: as set) and on the card
    (``again``: twice; and with each planted fault), both also in float32
    on the CPU and the card; with the quantizer's thresholds and patterns
    of the card's AMP and float32 steps. Keys: ``{step,eval}_{cpu,card}_
    {amp,f32}[_suffix]``."""
    model, batch, cfg = _retrieval_step0_setup(tmp)
    amp_model, _, _ = _retrieval_step0_setup(tmp, amp=True)

    def both(key, m, device):
        runs[f"step_{key}"] = _retrieval_step0(m, batch, cfg, device, False)
        runs[f"eval_{key}"] = _retrieval_eval_grads(m, batch, device)

    runs = {}
    both("cpu_f32", model, "cpu")
    threads = torch.get_num_threads()
    for n in cpu_threads:
        torch.set_num_threads(n or threads)
        try:
            both("cpu_amp" if n is None else f"cpu_amp_{n}_threads",
                 amp_model, "cpu")
        finally:
            torch.set_num_threads(threads)
    with _recorded_quantizer() as amp_calls:
        runs["step_card_amp"] = _retrieval_step0(amp_model, batch, cfg,
                                                 "cuda", False)
    runs["eval_card_amp"] = _retrieval_eval_grads(amp_model, batch, "cuda")
    with _recorded_quantizer() as f32_calls:
        runs["step_card_f32"] = _retrieval_step0(model, batch, cfg, "cuda",
                                                 False)
    if again:
        both("card_amp_again", amp_model, "cuda")
    for fault in faults:
        with _amp_fault(fault):
            both(f"card_amp_{fault}", amp_model, "cuda")
    return runs, amp_calls, f32_calls, model


def _amp_readings(runs, got, ref="cpu_amp"):
    """``got`` against ``ref`` in both runs, as :func:`_amp_ratios`."""
    return {kind: _amp_ratios(runs[f"{kind}_{got}"], runs[f"{kind}_{ref}"],
                              runs[f"{kind}_cpu_f32"])
            for kind in ("step", "eval")}


def _same_quantizer(amp_calls, f32_calls):
    """The AMP step's thresholds and patterns equal the float32 step's bit
    for bit, each threshold taken on a float32 weight; their counts."""
    n = {k: (len(amp_calls[k]), len(f32_calls[k])) for k in amp_calls}
    if any(a != b or a == 0 for a, b in n.values()):
        raise AssertionError(f"AMP vs float32 quantizer calls: {n}")
    for (dtype, t), (dtype32, t32) in zip(amp_calls["thresholds"],
                                          f32_calls["thresholds"]):
        if dtype != torch.float32 or dtype32 != torch.float32 \
                or not torch.equal(t, t32):
            raise AssertionError("AMP threshold differs from float32's")
    for p, p32 in zip(amp_calls["patterns"], f32_calls["patterns"]):
        if p.dtype != torch.float32 or not torch.equal(p, p32):
            raise AssertionError("AMP ternary pattern differs from "
                                 "float32's")
    return {"thresholds": n["thresholds"][0], "patterns": n["patterns"][0]}


# AMP by module (phase train_retrieval_amp): the eval comparison above
# can tell a fault only at the ResNet leaves, since one-ulp flips carried
# through the whole model read as much as a fault elsewhere. So each of
# the text tower (token ids in, pooled features out), the fusion
# (models/fusion.py, on the CPU AMP run's two embeddings) and the
# projectors (the image encoder's head, the text projector and the image
# projector with their LayerNorms, on the CPU AMP run's trunk features and
# text features; the similarity matrix and both embeddings out) runs
# alone, in eval mode, on the CPU's inputs, with the backward of
# <outputs, fixed cotangents> to its parameters; each is held by
# _amp_ratios' measure, sum|card - cpu_bf16| / sum|cpu_bf16 - cpu_f32|,
# over its outputs and over its gradients, within AMP_MODULE_LIMIT. The
# ResNet's planted faults carried over: the module's products left in
# float32 (every quantized layer's compute dtype dropped) and its
# LayerNorms in bf16; each must fail its module's limit.
# `--amp-modules` takes the readings at seeds 0-2.
AMP_MODULES = ("text_tower", "fusion", "projectors")
AMP_MODULE_FAULTS = ("products_f32", "norm_bf16")
# Readings (--amp-modules, seeds 0-2, one H100 80GB HBM3 at 700 W; the
# card's runs repeat bit for bit, the CPU at 1 thread reads 0 against 8):
# correct card, outputs / gradients: text tower 0.102-0.201 / 0.429-0.491
# (four layers of attention carry the flips on), fusion 0-0.059 /
# 0.008-0.164, projectors below 1e-4 / 1e-4; products in float32 1.0 /
# 1.0 everywhere; LayerNorms in bf16: text tower 1.29-1.41 / 1.23-1.33,
# fusion 1.15-1.27 / 1.13-1.26, projectors 0.98-1.14 / 1.40-1.50.
AMP_MODULE_LIMIT = {"text_tower": {"outputs": 0.5, "grads": 0.75},
                    "fusion": {"outputs": 0.3, "grads": 0.5},
                    "projectors": {"outputs": 0.1, "grads": 0.1}}
AMP_MODULE_SEEDS = (0, 1, 2)


class _Passthrough(torch.nn.Module):
    """An encoder that hands its input on (the projectors' run)."""

    def forward(self, x, *args, **kwargs):
        return x


def _amp_module_inputs(amp_model, batch):
    """The CPU AMP run's inputs to each module (eval mode), float32."""
    from atq_tpu_torch.train.retrieval import _batch_to

    images, ids, lengths = _batch_to(batch, torch.device("cpu"))
    with torch.no_grad():
        feats = amp_model.image_encoder.base_model(images).float()
        text = amp_model.text_encoder(ids, lengths).float()
        img, txt = amp_model(images, ids, lengths, return_embeddings=True,
                             train=False)
    return {"text_tower": (ids, lengths),
            "fusion": (img.float(), txt.float()),
            "projectors": (feats, text)}


@contextlib.contextmanager
def _norm_bf16():
    """The planted fault: every LayerNorm computed in bf16."""
    from atq_tpu_torch.nn.attention import LayerNorm32

    def forward(self, x):
        bf = torch.bfloat16
        return torch.nn.functional.layer_norm(
            x.to(bf), self.normalized_shape, self.weight.to(bf),
            self.bias.to(bf), self.eps).float()

    with mock.patch.object(LayerNorm32, "forward", forward):
        yield


def _amp_module_run(model, module, inputs, device, seed, fault=None):
    """``module``'s outputs and parameter gradients (the backward of
    <outputs, cotangents drawn from ``seed``>) of a copy of ``model`` on
    ``device`` in eval mode, on ``inputs``; ``fault`` plants
    ``products_f32`` or ``norm_bf16``."""
    import copy

    dev = torch.device(device)
    m = copy.deepcopy(model).to(dev).eval()
    if fault == "products_f32":
        for mod in m.modules():
            if getattr(mod, "dtype", None) == torch.bfloat16:
                mod.dtype = None
    x = _to_device(inputs, dev)
    with (_norm_bf16() if fault == "norm_bf16"
          else contextlib.nullcontext()):
        if module == "text_tower":
            outs = [m.text_encoder(*x)]
        elif module == "fusion":
            outs = [m.fusion({"image": x[0], "text": x[1]})]
        else:
            m.image_encoder.base_model = _Passthrough()
            m.text_encoder = _Passthrough()
            outs = list(m(*x, return_embeddings=True)) + [m(*x)]
        g = torch.Generator().manual_seed(5 + seed)
        cots = [torch.randn(o.shape, generator=g).to(dev) for o in outs]
        sum((o.float() * c).sum() for o, c in zip(outs, cots)).backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in m.named_parameters() if p.grad is not None}
    return [o.detach().double().cpu() for o in outs], grads


def _module_ratios(got, amp, f32):
    """Over the outputs and over the gradients: sum|got - amp| /
    sum|amp - f32|."""
    def ratio(g, a, f):
        return (sum((x - y).abs().sum().item() for x, y in zip(g, a))
                / sum((y - z).abs().sum().item() for y, z in zip(a, f)))

    keys = sorted(amp[1])
    return {"outputs": ratio(got[0], amp[0], f32[0]),
            "grads": ratio([got[1][k] for k in keys],
                           [amp[1][k] for k in keys],
                           [f32[1][k] for k in keys])}


def amp_module_readings(tmp, seeds=(0,), again=False, cpu_threads=(),
                        faults=AMP_MODULE_FAULTS):
    """Each module's ratios at each seed: the card's AMP run (twice with
    ``again``), the CPU's AMP run at each of ``cpu_threads`` and the
    planted faults, against the CPU's AMP run, each with its verdict."""
    out = {}
    threads = torch.get_num_threads()
    for seed in seeds:
        model, batch, _ = _retrieval_step0_setup(tmp, seed=seed)
        amp_model, _, _ = _retrieval_step0_setup(tmp, amp=True, seed=seed)
        inputs = _amp_module_inputs(amp_model, batch)
        for module in AMP_MODULES:
            def run(m, device, fault=None):
                return _amp_module_run(m, module, inputs[module], device,
                                       seed, fault)

            ref, f32 = run(amp_model, "cpu"), run(model, "cpu")
            got = {"card_amp": run(amp_model, "cuda")}
            if again:
                got["card_amp_again"] = run(amp_model, "cuda")
            for n in cpu_threads:
                torch.set_num_threads(n)
                try:
                    got[f"cpu_amp_{n}_threads"] = run(amp_model, "cpu")
                finally:
                    torch.set_num_threads(threads)
            for fault in faults:
                got[f"card_amp_{fault}"] = run(amp_model, "cuda", fault)
            for name, result in got.items():
                r = _module_ratios(result, ref, f32)
                r["within_limit"] = _amp_within(r, AMP_MODULE_LIMIT[module])
                out.setdefault(module, {}).setdefault(name, {})[seed] = r
    return out


def _amp_module_check(tmp):
    """train_retrieval_amp's module comparisons at seed 0: a correct card
    within each module's limit, each planted fault beyond it."""
    readings = amp_module_readings(tmp)
    for module, runs in readings.items():
        for name, by_seed in runs.items():
            if by_seed[0]["within_limit"] != (name == "card_amp"):
                raise AssertionError(
                    f"AMP {module} {name}: {by_seed[0]} against "
                    f"{AMP_MODULE_LIMIT[module]}")
    return {m: {n: r[0] for n, r in runs.items()}
            for m, runs in readings.items()}


def _gradcache_grads(model, batch, cfg, mode, fused=False):
    """One step (no update) of a copy of ``model`` on the card: ``mode``
    ``gradcache`` (cfg.grad_accum_steps microbatches), ``oracle`` (the
    concatenated-pool oracle) or ``plain`` (the whole batch at once).
    Returns the loss, every gradient (float64, on the host), the kernel
    launches, the peak memory allocated in the step above the resting
    allocation (bytes), the running statistics and the generator's state
    after the step."""
    import copy

    from atq_tpu_torch.data.augment import random_hflip
    from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import (
        _batch_to,
        _batchnorm_stats,
        build_retrieval_train_step,
        normalize_images,
        pool_loss,
    )

    dev = torch.device("cuda")
    m = copy.deepcopy(model).to(dev)
    b = _batch_to(batch, dev)
    criterion = HardNegativeMiningInfoNCE(lambda_reg=cfg.contrastive_reg)
    criterion.set_epoch(0, cfg.epochs)
    temperature = torch.tensor(criterion.get_current_temperature(),
                               device=dev)
    kind = torch.tensor(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    step_cfg = dataclasses.replace(
        cfg, grad_accum_steps=1 if mode == "plain" else GRADCACHE_N)
    os.environ["ATQ_FUSED"] = "1" if fused else "0"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated()
        _reset_launches()
        if mode == "oracle":
            micro = b[0].shape[0] // GRADCACHE_N
            m.zero_grad(set_to_none=True)
            img, txt = [], []
            for i in range(GRADCACHE_N):
                part = slice(i * micro, (i + 1) * micro)
                x = random_hflip(normalize_images(b[0][part]), gen)
                ie, te = m(x, b[1][part], b[2][part], return_embeddings=True,
                           train=True, generator=gen)
                img.append(ie.float())
                txt.append(te.float())
            loss = pool_loss(torch.cat(img), torch.cat(txt), temperature,
                             kind, None, None, step_cfg, criterion)
            loss.backward()
        else:
            loss = build_retrieval_train_step(m, _NoUpdate(), criterion,
                                              step_cfg, gen)(
                b, temperature, kind)
        torch.cuda.synchronize()
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated() - rest
    finally:
        os.environ["ATQ_FUSED"] = "0"
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().double().cpu() for n, p in m.named_parameters()}
    stats = [s.detach().cpu() for s in _batchnorm_stats(m)]
    out = (float(loss), grads, launches, peak, stats, gen.get_state())
    del m
    torch.cuda.empty_cache()
    return out


def _gradcache_compare(what, got, want):
    """Each leaf against ``want``'s within GRADCACHE_ATOL x (1 + its
    largest |gradient|); raises past it. Readings: the worst leaf's largest
    |difference| over that allowance, and its L2 difference over its
    norm, and the loss's relative difference."""
    worst_atol, worst_l2 = ("", 0.0), ("", 0.0)
    for n, w in want[1].items():
        d = (got[1][n] - w).abs().max().item()
        r = d / (GRADCACHE_ATOL * (1.0 + w.abs().max().item()))
        if r >= worst_atol[1]:
            worst_atol = (n, r)
        norm = w.norm().item()
        if norm > 0:
            l2 = (got[1][n] - w).norm().item() / norm
            if l2 >= worst_l2[1]:
                worst_l2 = (n, l2)
    out = {"loss_rel_diff": abs(got[0] - want[0]) / abs(want[0]),
           "worst_leaf_diff_over_allowance": worst_atol,
           "worst_leaf_l2_rel_diff": worst_l2}
    if worst_atol[1] > 1.0 or out["loss_rel_diff"] > 1e-5:
        raise AssertionError(f"{what}: {json.dumps(out)}")
    return out


def _read_until(proc, marker, timeout_s, lines):
    """Lines of ``proc``'s output into ``lines`` until one holds
    ``marker`` (returned) or the process ends or the time is up."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        line = proc.stdout.readline()
        if not line:
            return None
        lines.append(line.rstrip("\n"))
        if marker in line:
            return line
    return None


def _drill(tmp):
    """The preemption drill: ``python -m atq_tpu_torch.train.retrieval``
    on DRILL_ARGV, SIGKILLed once it reports orbax/step_1 committed, then
    rerun with --resume: it must say it resumed at epoch 1, train epoch 2
    only, exit 0, and restore a state whose digest is the one the first
    run saved."""
    import signal

    out_dir = os.path.join(tmp, "drill")
    argv = [sys.executable, "-u", "-m", "atq_tpu_torch.train.retrieval",
            *DRILL_ARGV, "--output_dir", out_dir, "--data_dir",
            os.path.join(tmp, "no_flickr8k")]
    first = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        saved = _read_until(proc, "Saved training state to", DRILL_TIMEOUT_S,
                            first)
        proc.send_signal(signal.SIGKILL)
        killed_after = time.perf_counter() - t0
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    if saved is None or "step_1 (sha256" not in saved \
            or proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"drill: no step_1 before the kill "
                             f"(rc {proc.returncode}): {first[-20:]}")
    saved_digest = saved.rsplit("sha256 ", 1)[1].strip().rstrip(")")
    t1 = time.perf_counter()
    rerun = subprocess.run(argv + ["--resume"], capture_output=True,
                           text=True, timeout=DRILL_TIMEOUT_S,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    second = rerun.stdout.splitlines()
    restored = [x for x in second if "Restored training state" in x]
    restored_digest = (restored[0].rsplit("sha256 ", 1)[1].strip()
                       .rstrip(")") if restored else None)
    checks = {
        "exit_0": rerun.returncode == 0,
        "resumed_at_epoch_1": any(
            x == f"Resumed from {os.path.join(out_dir, 'orbax')} at epoch 1"
            for x in second),
        "trained_epoch_2_only": (any(x.startswith("Epoch 2/2")
                                     for x in second)
                                 and not any(x.startswith("Epoch 1/2")
                                             for x in second)),
        "restored_equals_saved": restored_digest == saved_digest}
    if not all(checks.values()):
        raise AssertionError(f"drill: {checks}: {second[-30:]} "
                             f"{rerun.stderr[-2000:]}")
    return {**checks, "saved_sha256": saved_digest,
            "killed_after_s": killed_after,
            "rerun_s": time.perf_counter() - t1,
            "steps_left": sorted(os.listdir(os.path.join(out_dir,
                                                         "orbax")))}


def phase_train_retrieval_amp(tmp, drill):
    """The retrieval trainer under --use_amp and GradCache on the card:
    AMP step 0 against the CPU's and against float32 (the quantizer bit
    for bit), GradCache's gradients against the concatenated-pool oracle
    (dense and fused) with its launches and peak memory, one epoch of
    main() on the recipe with --use_amp --batch_size 64
    --grad_accum_steps 4 (counts reset before it, read after it) with 3
    traced steps after it, and the preemption drill's result ``drill``
    (its checks and seconds; it ran beside serve_aot's loaded-artifact
    process)."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import main as retrieval_main

    t0 = time.perf_counter()
    runs, amp_calls, f32_calls, model = _amp_step0_runs(
        tmp, faults=AMP_FAULTS)
    n_layers, n_large = _retrieval_path_layers(model)
    amp = {"card_vs_cpu": _amp_readings(runs, "card_amp"),
           "card_amp_vs_card_f32_loss_rel_diff": abs(
               runs["step_card_amp"][0] - runs["step_card_f32"][0])
           / abs(runs["step_card_f32"][0]),
           "quantizer_calls": _same_quantizer(amp_calls, f32_calls),
           "launches": runs["step_card_amp"][4]}
    for kind, limits in (("step", AMP_STEP_LIMIT), ("eval", AMP_EVAL_LIMIT)):
        if not _amp_within(amp["card_vs_cpu"][kind], limits):
            raise AssertionError(f"AMP {kind} card vs CPU past its limits "
                                 f"({limits}): {json.dumps(amp)}")
    _check_launches("AMP step 0", runs["step_card_amp"][4],
                    {"order_stat": n_large})
    for fault in AMP_FAULTS:
        amp[f"planted_{fault}"] = r = _amp_readings(runs, f"card_amp_{fault}")
        if _amp_within(r["eval"], AMP_EVAL_LIMIT):
            raise AssertionError(f"planted fault {fault} passes the AMP "
                                 f"eval limits: {json.dumps(r)}")
    del runs, model
    amp["modules"] = _amp_module_check(tmp)
    amp["module_limits"] = AMP_MODULE_LIMIT
    amp_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    model, batch, cfg = _retrieval_step0_setup(
        tmp, dropout=0.1, n=GRADCACHE_BATCH, raw_uint8=True)
    _, batch16, _ = _retrieval_step0_setup(tmp, dropout=0.1,
                                           n=RETRIEVAL_BATCH, raw_uint8=True)
    gc = _gradcache_grads(model, batch, cfg, "gradcache")
    oracle = _gradcache_grads(model, batch, cfg, "oracle")
    gc_fused = _gradcache_grads(model, batch, cfg, "gradcache", fused=True)
    plain64 = _gradcache_grads(model, batch, cfg, "plain")
    plain16 = _gradcache_grads(model, batch16, cfg, "plain")
    per_step = {"order_stat": n_large * 2 * GRADCACHE_N}
    _check_launches("GradCache step", gc[2], per_step)
    _check_launches("GradCache step fused", gc_fused[2], {
        **per_step, "fused_forward": n_layers * 2 * GRADCACHE_N,
        "fused_dx": n_layers * GRADCACHE_N,
        "fused_dwda": n_layers * GRADCACHE_N})
    if not all(torch.equal(a, b) for a, b in zip(gc[4], oracle[4])) \
            or not torch.equal(gc[5], oracle[5]):
        raise AssertionError("GradCache: running statistics or generator "
                             "state differ from the oracle's")
    if not gc[3] < plain64[3]:
        raise AssertionError(f"GradCache peak {gc[3]} not below the plain "
                             f"batch-64 step's {plain64[3]}")
    gradcache = {
        "batch": GRADCACHE_BATCH, "microbatches": GRADCACHE_N,
        "vs_oracle": _gradcache_compare("GradCache vs oracle", gc, oracle),
        "fused_vs_dense": _gradcache_compare("GradCache fused vs dense",
                                             gc_fused, gc),
        "launches": gc[2], "launches_fused": gc_fused[2],
        "peak_bytes_above_rest": {"gradcache_64": gc[3],
                                  "plain_64": plain64[3],
                                  "plain_16": plain16[3]},
        "loss": gc[0]}
    del model, gc, oracle, gc_fused, plain64, plain16
    gradcache_s = time.perf_counter() - t1

    out_dir = os.path.join(tmp, "retrieval_amp")
    argv = RETRIEVAL_AMP_ARGV + ["--output_dir", out_dir, "--data_dir",
                                 os.path.join(tmp, "no_flickr8k")]
    _reset_launches()
    t2 = time.perf_counter()
    state, history, report = retrieval_main(argv)
    wall = time.perf_counter() - t2
    launches = kernel_launches()
    stats = state["stats"]
    losses = stats["step_losses"][0]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"train_retrieval_amp: step losses {losses}")
    _check_launches("train_retrieval_amp", stats["launches_per_step"][0],
                    per_step)
    recalls = {f"mean_R@{k}": report["test_metrics"][f"mean_R@{k}"]
               for k in (1, 5, 10)}
    val = {f"mean_R@{k}": history["val_metrics"][0][f"mean_R@{k}"]
           for k in (1, 5, 10)}
    if not np.isfinite(list(recalls.values()) + list(val.values())).all():
        raise AssertionError(f"train_retrieval_amp: recalls {recalls}")
    busy = _traced_amp_steps(state["model"], state["optimizer"], tmp)

    drill, drill_s = drill
    emit({"phase": "train_retrieval_amp", "amp_step0": amp,
          "amp_step0_seconds": amp_s, "gradcache": gradcache,
          "gradcache_seconds": gradcache_s, "argv": RETRIEVAL_AMP_ARGV,
          "wall_s": wall, "steps": len(losses),
          "pairs_per_s": stats["pairs_per_sec"],
          "step_ms_p50": float(np.percentile(stats["step_ms"][0], 50)),
          "step_ms": stats["step_ms"][0],
          "epoch_seconds": stats["epoch_seconds"],
          "launches_per_step": stats["launches_per_step"],
          "launches": launches, "traced_steps": busy,
          "loss_first_step": losses[0], "loss_last_step": losses[-1],
          "recalls": {"val": val, "test": recalls},
          "drill": drill, "drill_seconds": drill_s})


def _traced_amp_steps(model, optimizer, tmp, warmup=2, steps=3):
    """Host and device ms a step and the busy share of ``steps`` traced
    steps (after ``warmup``) of the trainer's AMP GradCache step, on the
    trained model and its optimizer and the first GRADCACHE_BATCH training
    pairs (as uint8 images)."""
    from torch.profiler import ProfilerActivity, profile

    from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
    from atq_tpu_torch.train.retrieval import (
        _batch_to,
        build_retrieval_train_step,
    )

    _, batch, cfg = _retrieval_step0_setup(tmp, n=GRADCACHE_BATCH,
                                           raw_uint8=True)
    b = _batch_to(batch, torch.device("cuda"))
    cfg = dataclasses.replace(cfg, use_amp=True,
                              grad_accum_steps=GRADCACHE_N)
    criterion = HardNegativeMiningInfoNCE(lambda_reg=cfg.contrastive_reg)
    step = build_retrieval_train_step(
        model, optimizer, criterion, cfg,
        torch.Generator(device="cuda").manual_seed(3))
    args = (torch.tensor(0.07, device="cuda"),
            torch.tensor(0, device="cuda"))
    for _ in range(warmup):
        step(b, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(b, *args)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    breakdown, _ = _profiled_breakdown(prof, steps, seconds)
    return {"traced_ms_per_step": seconds * 1e3 / steps, **breakdown}


def retrieval_amp_step0_readings(tmp):
    """``--retrieval-amp-step0``: the readings behind train_retrieval_amp's
    AMP limits: in the train step and in eval mode, the card's AMP run
    (twice) against the CPU's (at 8 and 1 threads), the CPU's at 1 thread
    against 8, and the planted faults, each as :func:`_amp_ratios` with
    the phase's verdict."""
    runs, _, _, _ = _amp_step0_runs(tmp, cpu_threads=(None, 1), again=True,
                                    faults=AMP_FAULTS)
    out = {}
    for got in ("card_amp", "card_amp_again", "cpu_amp_1_threads",
                *(f"card_amp_{f}" for f in AMP_FAULTS)):
        r = _amp_readings(runs, got)
        out[f"{got}_vs_cpu_amp"] = {
            **r, "within_step_limits": _amp_within(r["step"],
                                                   AMP_STEP_LIMIT),
            "within_eval_limits": _amp_within(r["eval"], AMP_EVAL_LIMIT)}
    out["card_amp_vs_cpu_amp_1_thread"] = _amp_readings(
        runs, "card_amp", "cpu_amp_1_threads")
    out["card_f32_vs_cpu_f32_step_loss_rel_diff"] = abs(
        runs["step_card_f32"][0] - runs["step_cpu_f32"][0]) \
        / abs(runs["step_cpu_f32"][0])
    out["card_amp_vs_card_f32_step_loss_rel_diff"] = abs(
        runs["step_card_amp"][0] - runs["step_card_f32"][0]) \
        / abs(runs["step_card_f32"][0])
    emit({"phase": "retrieval_amp_step0_readings",
          "cpu_threads": torch.get_num_threads(), **out})
    return out


# --compare: the packed kernels at serving's head shapes (M = 32 and 1),
# the K-blocked shape and PACKED_SHAPES, and the fused kernels at the
# recipe's two head layers, old against new.
# The MoE phase (train_retrieval_moe): the README recipe with 8 experts a
# text layer. A token whose expert differs between the card and the CPU
# must be one whose two gate logits lie within MOE_GATE_GAP_RTOL of its
# largest |logit| (float32 products in another order can swap a near tie).
MOE_EXPERTS = 8
MOE_GATE_GAP_RTOL = 1e-6
MOE_TRAIN_ARGV = [a if a != "2" or RETRIEVAL_TRAIN_ARGV[i - 1] != "--epochs"
                  else "1" for i, a in enumerate(RETRIEVAL_TRAIN_ARGV)] \
    + ["--moe_experts", str(MOE_EXPERTS)]
# The trained checkpoint's model flags, for serving (dense; --packed added
# for the packed run) and evaluation (--packed --int8_trunk, as phase
# evaluate runs it).
MOE_MODEL_ARGV = ["--task", "retrieval"] + [
    a for a in RETRIEVAL_ARGV[2:] if a != "--packed"] + [
    "--moe_experts", str(MOE_EXPERTS)]
MOE_EVAL_ARGV = MOE_MODEL_ARGV + ["--packed", "--int8_trunk"]
# The stacks a text layer ternarizes each forward: w1's and w2's.
MOE_BATCHED_PER_LAYER = 2
MOE_TEXT_LAYERS = 4


@contextlib.contextmanager
def _moe_routing():
    """Records each MoE call of the text layers: its gate logits (float64,
    on the host), its valid-token mask and its aux loss."""
    from atq_tpu_torch.nn import transformer as ttr

    calls = []
    moe_ffn = ttr.moe_ffn

    def recording(x, params, *args, **kwargs):
        y, aux = moe_ffn(x, params, *args, **kwargs)
        mask = kwargs.get("token_mask")
        with torch.no_grad():
            calls.append({
                "logits": (x @ params["gate"]).double().cpu(),
                "valid": (mask.cpu() if mask is not None else
                          torch.ones(x.shape[0], dtype=torch.bool)),
                "aux": float(aux["aux_loss"])})
        return y, aux

    with mock.patch.object(ttr, "moe_ffn", recording):
        yield calls


def _routing_diff(card, cpu):
    """Tokens whose expert differs (valid tokens only), and the largest
    gate-logit gap of such a token over its largest |logit|."""
    differ, worst = 0, 0.0
    for a, b in zip(card, cpu):
        if not torch.equal(a["valid"], b["valid"]):
            raise AssertionError("MoE step 0: the token masks differ")
        ea, eb = a["logits"].argmax(1), b["logits"].argmax(1)
        rows = torch.nonzero(a["valid"] & (ea != eb)).flatten()
        differ += len(rows)
        for t in rows.tolist():
            lg = b["logits"][t]
            worst = max(worst, float(abs(lg[ea[t]] - lg[eb[t]])
                                     / lg.abs().max()))
    return differ, worst


def _expert_patterns_equal(model):
    """The experts' ternary patterns of every text layer, card against CPU,
    bit for bit (the quantizer at the layers' sparsity)."""
    from atq_tpu_torch.core.quantize import (
        adaptive_ternary_quantization_batched,
    )

    planes = 0
    for i in range(MOE_TEXT_LAYERS):
        layer = getattr(model.text_encoder, f"layers_{i}")
        for w in (layer.moe_w1, layer.moe_w2):
            w = w.detach().cpu()
            cpu, _ = adaptive_ternary_quantization_batched(
                w, sparsity_target=layer.moe_sparsity)
            card, _ = adaptive_ternary_quantization_batched(
                w.cuda(), sparsity_target=layer.moe_sparsity)
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"MoE layer {i}: the expert patterns "
                                     f"differ on the card")
            planes += w.shape[0]
    return planes


@contextlib.contextmanager
def _no_plain_on_cuda():
    """Counts the batched order statistic's plain version reached with a
    CUDA tensor (it must never be)."""
    from atq_tpu_torch.ops import order_stat

    hits = []
    plain = order_stat.order_statistic_batched_plain

    def counted(abs2d, ranks):
        if abs2d.is_cuda:
            hits.append(tuple(abs2d.shape))
        return plain(abs2d, ranks)

    with mock.patch.object(order_stat, "order_statistic_batched_plain",
                           counted):
        yield hits


def _moe_serve(ckpt, device, packed, images, texts):
    """A trained checkpoint through the serve CLI's retrieval routes on
    ``device``: the embeddings of ``images`` (each sent alone, normalized)
    and ``texts``, and the card's launches."""
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.__main__ import (
        build_parser,
        build_retrieval_routes,
    )
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = build_parser().parse_args(
        MOE_MODEL_ARGV + ["--checkpoint", ckpt, "--device", device,
                          "--max_wait_ms", "1"] + ["--packed"] * packed)
    _reset_launches()
    routes, servers = build_retrieval_routes(args, load_checkpoint(ckpt),
                                             "parity", torch.device(device))
    try:
        img = [routes["/embed_image"]({"image": im.tolist(),
                                       "normalize": True})["embedding"]
               for im in images]
        txt = [routes["/embed_text"]({"text": t})["embedding"]
               for t in texts]
    finally:
        for s in servers:
            s.stop()
    return np.asarray(img), np.asarray(txt), kernel_launches()


def phase_train_retrieval_moe(tmp):
    """The ternary-expert MoE FFN (--moe_experts 8) at the README widths:
    step 0 card against CPU, one epoch of the trainer's main(), serving and
    evaluation of its final_model.npz against the CPU (the docstring's
    train_retrieval_moe)."""
    from atq_tpu_torch.data.flickr8k import Flickr8kDataset, load_vocab_file
    from atq_tpu_torch.evaluate import main as evaluate_main
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.train.retrieval import main as retrieval_main

    t0 = time.perf_counter()
    model, batch, cfg = _retrieval_step0_setup(tmp, moe_experts=MOE_EXPERTS)
    n_layers, n_large = _retrieval_path_layers(model)
    per_step = {"order_stat": n_large, "batched_order_stat":
                MOE_BATCHED_PER_LAYER * MOE_TEXT_LAYERS}
    with _moe_routing() as cpu_calls:
        cpu = _retrieval_step0(model, batch, cfg, "cpu", False)
    with _moe_routing() as card_calls:
        card = _retrieval_step0(model, batch, cfg, "cuda", False)
    _check_launches("MoE step 0", card[4], per_step)
    step0 = _compare_retrieval_step0("MoE", card, cpu, RET_GRAD_TOL_CPU,
                                     RET_LEAF_TOL_CPU)
    # The step's own calls (the first four; the embeddings' forward after
    # it runs the layers again).
    step_card, step_cpu = (c[:MOE_TEXT_LAYERS] for c in (card_calls,
                                                         cpu_calls))
    differ, gap = _routing_diff(step_card, step_cpu)
    aux_rel = max(abs(a["aux"] - b["aux"]) / abs(b["aux"])
                  for a, b in zip(step_card, step_cpu))
    tokens = int(sum(c["valid"].sum() for c in step_cpu))
    planes = _expert_patterns_equal(model)
    if gap > MOE_GATE_GAP_RTOL or aux_rel > RET_LOSS_RTOL:
        raise AssertionError(f"MoE step 0: {differ} of {tokens} tokens "
                             f"routed otherwise, gate-logit gap {gap} "
                             f"(limit {MOE_GATE_GAP_RTOL}); aux rel diff "
                             f"{aux_rel} (limit {RET_LOSS_RTOL})")
    step0.update({"launches": card[4], "routed_tokens": tokens,
                  "tokens_routed_otherwise": differ,
                  "max_gate_gap_over_max_logit": gap,
                  "gate_gap_limit": MOE_GATE_GAP_RTOL,
                  "aux_loss": [c["aux"] for c in step_card],
                  "aux_rel_diff": aux_rel,
                  "expert_planes_bit_equal": planes})
    del model, cpu, card
    step0_s = time.perf_counter() - t0

    out_dir = os.path.join(tmp, "retrieval_moe")
    data_dir = os.path.join(tmp, "no_flickr8k")
    _reset_launches()
    t1 = time.perf_counter()
    with _no_plain_on_cuda() as plain_hits:
        state, history, report = retrieval_main(
            MOE_TRAIN_ARGV + ["--output_dir", out_dir, "--data_dir",
                              data_dir])
    wall = time.perf_counter() - t1
    launches = kernel_launches()
    stats = state["stats"]
    losses = [x for epoch in stats["step_losses"] for x in epoch]
    if len(losses) != RETRIEVAL_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train_retrieval_moe: {len(losses)} step "
                             f"losses, finite {np.isfinite(losses).all()}")
    _check_launches("train_retrieval_moe", stats["launches_per_step"][0],
                    per_step)
    if plain_hits:
        raise AssertionError(f"train_retrieval_moe: the batched statistic's "
                             f"plain version took CUDA tensors "
                             f"{plain_hits[:3]}")
    recalls = {f"mean_R@{k}": report["test_metrics"][f"mean_R@{k}"]
               for k in (1, 5, 10)}
    if not np.isfinite(list(recalls.values())).all():
        raise AssertionError(f"train_retrieval_moe: recalls {recalls}")
    # One epoch writes best_model.npz only when its R@1 beats 0;
    # final_model.npz, the same weights when it does, is always there.
    ckpt = os.path.join(out_dir, "final_model.npz")

    vocab = load_vocab_file(os.path.join(out_dir, "vocab.json"))
    val = Flickr8kDataset(data_dir, "val", image_size=IMAGE_SIZE,
                          max_length=SEQ_LEN, vocab=vocab, raw_uint8=True)
    images = [val[i][0].astype(np.float32) / 255.0 for i in range(4)]
    texts = ["a dog runs on the grass", "two children play in the water",
             "a man rides a bike", "a girl in a red dress"]
    t2 = time.perf_counter()
    serving = {}
    for packed in (False, True):
        got = _moe_serve(ckpt, "cuda", packed, images, texts)
        want = _moe_serve(ckpt, "cpu", packed, images, texts)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got[:2],
                                                            want[:2]))
        name = "packed" if packed else "dense"
        serving[name] = {"max_abs_diff": err, "limit": RETRIEVAL_ATOL,
                         "launches": {k: v for k, v in got[2].items() if v}}
        if err > RETRIEVAL_ATOL or got[2]["batched_order_stat"] != \
                MOE_BATCHED_PER_LAYER * MOE_TEXT_LAYERS * len(texts):
            raise AssertionError(f"train_retrieval_moe serve {name}: "
                                 f"{serving[name]}")
    serve_s = time.perf_counter() - t2

    t3 = time.perf_counter()
    evals = {}
    for device in ("cuda", "cpu"):
        _reset_launches()
        evals[device] = evaluate_main(
            MOE_EVAL_ARGV + ["--checkpoint", ckpt, "--data_dir", data_dir,
                             "--device", device])
        if device == "cuda":
            eval_launches = {k: v for k, v in kernel_launches().items() if v}
    got, want = evals["cuda"], evals["cpu"]
    diffs = {k: abs(got[k] - want[k]) for k in want}
    if any(d > 0 for d in diffs.values()):
        # Near-tied scores may move: held as phase evaluate holds them.
        img, txt = _moe_eval_embeddings(ckpt, data_dir)
        slack = _recall_slack(img, txt, RETRIEVAL_ATOL)
        bad = {k: d for k, d in diffs.items()
               if d > slack["dedup" if k.endswith("_dedup")
                            else k.split("_R@")[0]]}
        if bad:
            raise AssertionError(f"train_retrieval_moe evaluate: R@K "
                                 f"beyond slack {bad}")
    emit({"phase": "train_retrieval_moe", "argv": MOE_TRAIN_ARGV,
          "step0": step0, "step0_seconds": step0_s, "wall_s": wall,
          "steps": len(losses), "pairs_per_s": stats["pairs_per_sec"],
          "step_ms_p50": [float(np.percentile(t, 50))
                          for t in stats["step_ms"]],
          "launches_per_step": stats["launches_per_step"],
          "launches": launches, "loss_first_step": losses[0],
          "loss_last_step": losses[-1], "test_recalls": recalls,
          "serve": serving, "serve_seconds": serve_s,
          "evaluate": {"cuda": got, "cpu": want, "abs_diff": diffs,
                       "launches": eval_launches,
                       "seconds": time.perf_counter() - t3},
          "seconds": time.perf_counter() - t0})
    return launches


def _moe_eval_embeddings(ckpt, data_dir):
    """The evaluation's test-split embeddings on the card (for the slack of
    near-tied scores)."""
    from atq_tpu_torch.data.flickr8k import prepare_flickr8k_dataloaders
    from atq_tpu_torch.evaluate import build_parser as eval_parser
    from atq_tpu_torch.serve.__main__ import build_retrieval
    from atq_tpu_torch.train.retrieval import _batch_to, build_embed_fn
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = eval_parser().parse_args(MOE_EVAL_ARGV + ["--checkpoint", ckpt])
    _, _, loader, vocab_size, _ = prepare_flickr8k_dataloaders(
        batch_size=EVAL_BATCH, image_size=IMAGE_SIZE, max_length=SEQ_LEN,
        root_dir=data_dir,
        vocab_file=os.path.join(os.path.dirname(ckpt), "vocab.json"))
    dev = torch.device("cuda")
    embed = build_embed_fn(build_retrieval(args, load_checkpoint(ckpt),
                                           "parity", dev, vocab_size))
    img, txt = zip(*(tuple(e.cpu().numpy() for e in embed(
        _batch_to(b, dev))) for b in loader))
    return np.concatenate(img), np.concatenate(txt)


# ResNet rewrites (resnet_rewrites): ResNet-18 at 160x160 in eval mode
# (BatchNorm on its running statistics; 16 images). Limits: the features
# with both flags within 1e-4 of the default path's largest |value| (the
# stem's sum in another order and cuDNN's algorithms); the space-to-depth
# stem's output and gradients (input and kernel, a random cotangent)
# within 1e-4 of the direct stem's largest |value| (the CPU at these
# shapes: 4.2e-7, 5.6e-7 and 9.6e-6, the kernel's a sum over 102,400
# positions); the stem pool's gradient on a tie-free input within 1e-6 of
# PyTorch's backward's largest, and the tie-split one within 1e-6 of the
# CPU's (the same adds; a tie count divides), its sum kept within 1e-5.
# The whole network's gradients with the space-to-depth stem are printed
# against the default path's, each leaf in L2, and not held: an ulp of
# difference moves a near-tied max of the stem pool, and with it an
# element's whole gradient (1.4e-3 on the card, 3.0e-5 on the CPU at
# 96x96 and 4 images, where fewer windows can tie).
REWRITE_TOL = {"features": 1e-4, "s2d_stem": 1e-4, "pool_no_ties": 1e-6,
               "pool_ties_vs_cpu": 1e-6, "pool_grad_sum_rel": 1e-5}


def phase_resnet_rewrites():
    from atq_tpu_torch.models.resnet import ResNetFeatures
    from atq_tpu_torch.ops.fast_pool import fast_max_pool
    from atq_tpu_torch.ops.s2d_stem import stem_conv

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(31)
    model = ResNetFeatures(device="cuda", generator=gen)
    x = torch.randn(16, IMAGE_SIZE, IMAGE_SIZE, 3, generator=gen).cuda()
    cot = torch.randn(16, 512, generator=gen).cuda()

    def run(flags, grads=False):
        with mock.patch.dict(os.environ, flags):
            xi = x.clone().requires_grad_(grads)
            model.zero_grad(set_to_none=True)
            with torch.set_grad_enabled(grads):
                y = model(xi)
                if not grads:
                    return y
                (y * cot).sum().backward()
            return {"input": xi.grad, **{n: p.grad for n, p in
                                         model.named_parameters()}}

    off = {"ATQ_S2D_STEM": "0", "ATQ_FAST_POOL": "0"}
    ref = run(off)
    both = run({"ATQ_S2D_STEM": "1", "ATQ_FAST_POOL": "1"})
    readings = {"features": float((both - ref).abs().max()
                                  / ref.abs().max())}
    g_ref = run(off, grads=True)
    g_s2d = run({"ATQ_S2D_STEM": "1", "ATQ_FAST_POOL": "0"}, grads=True)
    worst = max((float((g_s2d[k] - g).norm() / g.norm()), k)
                for k, g in g_ref.items())
    net = {"worst_leaf_l2": worst[0], "leaf": worst[1]}

    # The stem alone, direct and space-to-depth: output, dx and dw.
    xs = x.permute(0, 3, 1, 2).contiguous()
    c = torch.randn(16, 64, IMAGE_SIZE // 2, IMAGE_SIZE // 2,
                    generator=gen).cuda()
    stems = {}
    for use_s2d in (False, True):
        xi = xs.clone().requires_grad_()
        wi = model.conv1.weight.detach().clone().requires_grad_()
        y = stem_conv(xi, wi, use_s2d=use_s2d)
        (y * c).sum().backward()
        stems[use_s2d] = (y.detach(), xi.grad, wi.grad)
    readings["s2d_stem"] = max(float((b - a).abs().max() / a.abs().max())
                               for a, b in zip(stems[False], stems[True]))

    # The stem pool: a tie-free map against PyTorch's max-pool backward,
    # and the stem's own post-ReLU map (ties at 0) against the CPU.
    with torch.no_grad():
        stem = torch.relu(model.bn1(model.conv1(xs)))
    shape = stem.shape
    unique = (torch.randperm(stem.numel(), generator=gen).float()
              / stem.numel()).reshape(shape).cuda()
    g = torch.randn(16, shape[1], shape[2] // 2, shape[3] // 2,
                    generator=gen).cuda()

    def pool_grad(inp, fn):
        inp = inp.clone().requires_grad_()
        fn(inp).backward(g.to(inp.device))
        return inp.grad

    torch_pool = (lambda t: torch.nn.functional.max_pool2d(t, 3, 2, 1))
    a, b = pool_grad(unique, fast_max_pool), pool_grad(unique, torch_pool)
    readings["pool_no_ties"] = float((a - b).abs().max() / b.abs().max())
    card = pool_grad(stem, fast_max_pool)
    cpu = pool_grad(stem.cpu(), fast_max_pool)
    readings["pool_ties_vs_cpu"] = float((card.cpu() - cpu).abs().max()
                                         / cpu.abs().max())
    readings["pool_grad_sum_rel"] = float(abs(card.sum() - g.sum())
                                          / g.abs().sum())
    bad = {k: (v, REWRITE_TOL[k]) for k, v in readings.items()
           if v > REWRITE_TOL[k]}
    if bad:
        raise AssertionError(f"resnet_rewrites past the limits: {bad}")
    emit({"phase": "resnet_rewrites", "readings": readings,
          "limits": REWRITE_TOL, "s2d_network_grads": net,
          "stem_zero_share": float((stem == 0).float().mean()),
          "shape": [16, IMAGE_SIZE, IMAGE_SIZE, 3],
          "seconds": time.perf_counter() - t0})


COMPARE_MM = tuple((m, n, k) for m in (MAX_BATCH, 1) for n, k in MM_SHAPES) \
    + ((128, 128, 8704),)
PACKED_KERNELS = ("ternary_matmul", "ternary_matmul32", "ternary_matmul_rpb")
FUSED_KERNELS = ("fused_forward", "fused_dx", "fused_dwda")


def attention_bwd_digest():
    """sha256 of the attention backward's dq, dk, dv bytes over ATTN_CASES,
    from inputs drawn with seed 0: two trees whose backward gives the same
    bits give the same digest."""
    import hashlib

    from atq_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    digest = hashlib.sha256()
    for shape, dtype, with_bias in ATTN_CASES:
        q, k, v, do, bias = _attn_inputs(gen, shape, dtype, with_bias)
        scale = 1.0 / float(np.sqrt(shape[3]))
        for grad in fa.fused_attention_backward(q, k, v, scale, bias, do):
            digest.update(grad.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
    return digest.hexdigest()


def order_stat_rows(mod, gen):
    """Both order-statistic wrappers of the tree whose chip_smoke is
    ``mod`` at the main paths' shapes: its time_order_stat and
    time_batched_order_stat rows, each with its stream operations a call
    (this file's count, on the tree's wrappers)."""
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_reductions,
        order_statistic_reductions_batched,
    )

    rows = []
    for n in (OS_SIZES[0],) + RETRIEVAL_OS_SIZES:
        row = mod.time_order_stat(gen, n)
        x = torch.randn(n, device="cuda", generator=gen).abs()
        rank = torch.tensor([row["rank"]], dtype=torch.int32, device="cuda")
        row["stream_ops"] = stream_ops_per_call(
            lambda: order_statistic_reductions(x, rank))
        rows.append(row)
    for lead, n in BATCHED_OS_SHAPES[:2] + (MOE_OS_SHAPE,):
        row = mod.time_batched_order_stat(gen, lead, n)
        x = torch.randn(lead, n, device="cuda", generator=gen).abs()
        ranks = torch.full((lead,), row["rank"], dtype=torch.int32,
                           device="cuda")
        row["stream_ops"] = stream_ops_per_call(
            lambda: order_statistic_reductions_batched(x, ranks))
        rows.append(row)
    return rows


# The kinds --time-tree and --compare take by default; "encoder"
# (encoder_run, about a minute a run) only when named.
TIME_KINDS = ("matmul", "packed", "fused", "attention", "order_stat")


def time_tree(tree, out, *kinds):
    """Times the kernels with ``tree``'s own chip_smoke.py and
    atq_tpu_torch (which build that tree's kernels) at COMPARE_MM
    (time_matmul), PACKED_SHAPES (time_packed), where the tree has
    time_fused, the first two FUSED_SHAPES, where it has time_attention,
    bert-base's attention call, and both order statistics at the main
    paths' shapes (order_stat_rows); writes them to ``out``. ``kinds``
    (TIME_KINDS) limits it to those; ``attention`` also takes the
    attention backward's digest (attention_bwd_digest, this file's, on
    the tree's kernels). Run it in a process that has not imported
    atq_tpu_torch: the tree's package must be the one imported."""
    out = os.path.abspath(out)
    tree = _enter_tree(tree, "--time-tree")
    mod = importlib.import_module("chip_smoke")
    import atq_tpu_torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    kinds = set(kinds or TIME_KINDS)
    result = {"tree": tree, "package": atq_tpu_torch.__file__,
              "matmul": [mod.time_matmul(gen, *s) for s in COMPARE_MM]
              if "matmul" in kinds else None,
              "packed": [mod.time_packed(gen, *s) for s in PACKED_SHAPES]
              if "packed" in kinds else None,
              "fused": [mod.time_fused(gen, *s) for s in FUSED_SHAPES[:2]]
              if "fused" in kinds and hasattr(mod, "time_fused") else None,
              "attention": mod.time_attention(
                  torch.Generator(device="cuda").manual_seed(0))
              if "attention" in kinds and hasattr(mod, "time_attention")
              else None,
              "attention_bwd_digest": attention_bwd_digest()
              if "attention" in kinds else None,
              "order_stat": order_stat_rows(
                  mod, torch.Generator(device="cuda").manual_seed(0))
              if "order_stat" in kinds else None,
              "encoder": encoder_run() if "encoder" in kinds else None}
    with open(out, "w") as f:
        json.dump(result, f)


def compare(parent, out_dir="outputs/compare", *kinds):
    """The kernels of ``parent`` (another checkout) and of this tree on one
    card, in turns parent, this, this, parent, each in a process of its
    own; device ms (torch.profiler) at every shape, and summed per batch
    on each main path. ``kinds`` (TIME_KINDS, all by default) limits the
    kernels. Each run's rows go to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    kinds = tuple(kinds) or TIME_KINDS
    runs = []
    for i, tree in enumerate((parent, ".", ".", parent)):
        path = os.path.abspath(os.path.join(out_dir, f"compare_{i}.json"))
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-tree", tree, path, *kinds], check=True,
                       timeout=900)
        with open(path) as f:
            runs.append(json.load(f))
    old, new = (runs[0], runs[3]), (runs[1], runs[2])

    def pick(pair, what, i, name):
        rows = [r[what][i] if name is None else r[what][i][name]
                for r in pair]
        return rows, float(np.mean([r["kernel_device_ms"] for r in rows
                                    if r["kernel_device_ms"] is not None]))

    ms = {}
    per_batch = {}
    if "matmul" in kinds and "packed" in kinds:
        cases = [("matmul", i, None, "ternary_matmul", (m, k, n))
                 for i, (m, n, k) in enumerate(COMPARE_MM)]
        cases += [("packed", i, name, name, shape)
                  for i, shape in enumerate(PACKED_SHAPES)
                  for name in PACKED_KERNELS]
        for what, i, key, name, (m, k, n) in cases:
            old_rows, old_ms = pick(old, what, i, key)
            new_rows, new_ms = pick(new, what, i, key)
            ms[name, m, k, n] = (old_ms, new_ms)
            emit({"compare": name, "m": m, "k": k, "n": n,
                  "old_ms": old_ms, "new_ms": new_ms,
                  "new_over_old": new_ms / old_ms,
                  "old_runs": [r["kernel_device_ms"] for r in old_rows],
                  "new_runs": [r["kernel_device_ms"] for r in new_rows],
                  "library_ms": float(np.mean([r["library_device_ms"]
                                               for r in new_rows])),
                  "bound_ms": new_rows[0]["bound_ms"],
                  "bound_by": new_rows[0]["bound_by"]})
        # Per batch: serve_packed's head at M = 32; a text batch's 24
        # layer projections and attention_pool_0 at M = 1600; an image
        # batch's projector.
        text = ((16, 192, 192), (4, 192, 384), (4, 384, 192),
                (1, 192, 96))
        per_batch["serve_packed"] = [
            sum(ms["ternary_matmul", MAX_BATCH, k, n][j]
                for n, k in MM_SHAPES[:2]) for j in (0, 1)]
        for name in PACKED_KERNELS:
            per_batch[f"text_batch_{name}"] = [
                sum(c * ms[name, 1600, k, n][j] for c, k, n in text)
                for j in (0, 1)]
            per_batch[f"image_batch_{name}"] = list(ms[name, 32, 512, 192])
    if all(r.get("fused") for r in runs):
        # train_fused's step: each kernel once on each head layer.
        for name in FUSED_KERNELS:
            for i, (m, n, k) in enumerate(FUSED_SHAPES[:2]):
                old_rows, old_ms = pick(old, "fused", i, name)
                new_rows, new_ms = pick(new, "fused", i, name)
                ms[name, m, n, k] = (old_ms, new_ms)
                emit({"compare": name, "m": m, "n": n, "k": k,
                      "old_ms": old_ms, "new_ms": new_ms,
                      "new_over_old": new_ms / old_ms,
                      "old_runs": [r["kernel_device_ms"] for r in old_rows],
                      "new_runs": [r["kernel_device_ms"] for r in new_rows],
                      "library_ms": float(np.mean(
                          [r["library_device_ms"] for r in new_rows])),
                      "old_library_ms": float(np.mean(
                          [r["library_device_ms"] for r in old_rows])),
                      "bound_ms": new_rows[0]["bound_ms"],
                      "bound_by": new_rows[0]["bound_by"]})
            per_batch[f"train_fused_step_{name}"] = [
                sum(ms[name, m, n, k][j] for m, n, k in FUSED_SHAPES[:2])
                for j in (0, 1)]
    if all(r.get("attention") for r in runs):
        # train_encoder's step: the forward 24 times, the backward 12.
        for name, per_step in (("fused_attention_fwd", 24),
                               ("fused_attention_bwd", 12)):
            old_rows = [r["attention"][name] for r in old]
            new_rows = [r["attention"][name] for r in new]
            old_ms, new_ms = (float(np.mean([r["kernel_device_ms"]
                                             for r in rows]))
                              for rows in (old_rows, new_rows))
            emit({"compare": name, "shape": new_rows[0]["shape"],
                  "old_ms": old_ms, "new_ms": new_ms,
                  "new_over_old": new_ms / old_ms,
                  "old_runs": [r["kernel_device_ms"] for r in old_rows],
                  "new_runs": [r["kernel_device_ms"] for r in new_rows],
                  "old_launches_device_ms": [
                      r.get("kernel_launches_device_ms") for r in old_rows],
                  "new_launches_device_ms": [
                      r.get("kernel_launches_device_ms") for r in new_rows],
                  "library_ms": float(np.mean(
                      [r["library_device_ms"] for r in new_rows])),
                  "old_library_ms": float(np.mean(
                      [r["library_device_ms"] for r in old_rows])),
                  "bound_ms": new_rows[0]["bound_ms"],
                  "bound_by": new_rows[0]["bound_by"]})
            per_batch[f"train_encoder_step_{name}"] = [
                per_step * old_ms, per_step * new_ms]
    if "attention" in kinds:
        # Every run times the attention kind, so every run has a digest.
        digests = [r.get("attention_bwd_digest") for r in runs]
        emit({"compare": "fused_attention_bwd_bits",
              "same_bits": len(set(digests)) == 1 and all(digests),
              "digests": digests})
        if not all(digests):
            raise AssertionError("a run took no attention backward "
                                 f"digest: {digests}")
        if len(set(digests)) != 1:
            raise AssertionError("the attention backward's bits differ "
                                 f"between the trees: {digests}")
    if "order_stat" in kinds:
        # Both wrappers at the main paths' shapes: device ms (profiler),
        # event ms and stream operations a call; train_encoder's step takes
        # the batched one 4 times at (12, 589,824) and twice at
        # (12, 2,359,296).
        for i, new_row in enumerate(runs[1]["order_stat"]):
            shape = {k: new_row[k] for k in ("lead", "n") if k in new_row}
            rows = {j: r["order_stat"][i] for j, r in enumerate(runs)}
            old_ms, new_ms = (float(np.mean([rows[j]["kernel_device_ms"]
                                             for j in js]))
                              for js in ((0, 3), (1, 2)))
            emit({"compare": "batched_order_stat" if "lead" in shape
                  else "order_stat", **shape,
                  "old_ms": old_ms, "new_ms": new_ms,
                  "new_over_old": new_ms / old_ms,
                  "old_runs": [rows[j]["kernel_device_ms"] for j in (0, 3)],
                  "new_runs": [rows[j]["kernel_device_ms"] for j in (1, 2)],
                  "old_event_ms": [rows[j]["kernel_ms"] for j in (0, 3)],
                  "new_event_ms": [rows[j]["kernel_ms"] for j in (1, 2)],
                  "old_stream_ops": [rows[j]["stream_ops"] for j in (0, 3)],
                  "new_stream_ops": [rows[j]["stream_ops"] for j in (1, 2)],
                  "library_ms": float(np.mean(
                      [rows[j]["library_device_ms"] for j in (1, 2)])),
                  "plain_ms": float(np.mean(
                      [rows[j]["plain_device_ms"] for j in (1, 2)])),
                  "bound_ms": new_row["bound_ms"],
                  "bound_by": new_row["bound_by"]})
            if shape.get("lead") == 12:
                calls = 4 if shape["n"] == 589824 else 2
                per_batch[f"train_encoder_step_batched_order_stat_"
                          f"{shape['n']}"] = [calls * old_ms, calls * new_ms]
    if "encoder" in kinds:
        # train_encoder's step in each run: ms/step, tokens/s and MFU from
        # the timed window, device ms from the traced pair of steps.
        keys = ("ms_per_step", "tokens_per_sec", "mfu_pct",
                "traced_device_ms_per_step", "traced_busy_share")
        for what, pair in (("old", old), ("new", new)):
            emit({"compare": "train_encoder", "tree": what,
                  **{key: [r["encoder"][key] for r in pair] for key in keys},
                  "attention_device_ms_per_step": [
                      r["encoder"]["attention_device_ms_per_step"]
                      for r in pair]})
    emit({"per_batch_device_ms_old_new": per_batch})


# ------------------------------------------------------------ scale_out
#
# The multi-GPU scale-out (parallel/, the trainers' --dp/--tp/--fsdp) on
# every card of the machine, N = torch.cuda.device_count(), through torchrun
# (one process a card, NCCL; the checks at N = 1 over gloo, two ranks on
# the card): each worker mode below runs in every rank and rank 0 writes
# what it read. Step 0 of the README recipe's widths at the global batch
# 16 a rank is held against the one-GPU step on the same batch,
# with a planted fault (every dα dropped) that must fail, and the
# order-statistic launches a step equal to the one-GPU step's. The limits
# (_scale_compare): the loss within RET_LOSS_RTOL and the embeddings within
# RET_EMBED_ATOL, or SCALE_ENVELOPE times how far the one-GPU step moves
# them when its images are scaled by 1 ± 1e-6, where that is larger; each
# gradient leaf above rounding within its train_retrieval card-vs-CPU
# limit (RET_LEAF_TOL_CPU by _leaf_group) of its L2 norm plus
# SCALE_ENVELOPE times that leaf's own move. The sharded step sums its
# gradients over the ranks and takes BatchNorm's statistics from the
# ranks' sums; float reassociation alone then moves the trunk's nearly
# cancelling leaves (on the CPU at N = 4 with --moe_experts 8: a trunk
# leaf by 2.0e-2 of its norm and the largest element by 2.0e-2 of the
# largest gradient, the text tensors by 2.8e-4; tests/_dp_reference.py
# has the same envelope on the CPU).
SCALE_ENVELOPE = 10.0
SCALE_ROWS = 16  # a card's rows: the global --batch_size is 16·N
SCALE_STEPS = 8  # the short epoch's steps: --synthetic_images 32·N
SCALE_TRAIN_ARGV = ["--embed_dim", "192", "--hidden_dim", "384",
                    "--learning_rate", "5e-5", "--image_size", "160",
                    "--use_residual", "--reinit_model", "--gradual_quant",
                    "--warmup_epochs", "2", "--contrastive_reg", "0.05",
                    "--epochs", "1", "--checkpoint_freq", "1"]
SCALE_CLASSIFIER_ARGV = ["--use-rpb", "--distill", "--use-l1",
                         "--clip-grad", "--epochs", "1",
                         "--subset-fraction", "0.05"]
# The library at the recipe's text-tower widths: moe_ffn_sharded with 8
# experts over the group (8/N a card; 800 tokens a rank), the row-sharded
# search of 1,000 embeddings of 192 (float32 and int8), ring attention over
# a sequence of 64 a rank's block times the group (16 x 8 heads x 24), and
# a GPipe of one stage a rank (a 192-wide tanh layer, 8 microbatches).
# Each against the one-process port on the same card within LIBRARY_TOL.
LIBRARY_TOL = 1e-4
MOE_EXPERTS, MOE_ROWS = 8, 800


def _torchrun(n, args, timeout=600):
    """``torchrun --nproc_per_node n chip_smoke.py ARGS`` from this
    checkout; raises on a non-zero exit."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", str(n), "--master_port", str(port),
           os.path.abspath(__file__)] + [str(a) for a in args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"torchrun {args[:2]} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-8000:]}")
    return time.perf_counter() - t0


def _rank0_write(out, value):
    from atq_tpu_torch.parallel.mesh import world_rank

    if world_rank() == 0:
        torch.save(value, out)


def _scale_step0(spec, device):
    """Step 0 of each of the spec's configs over a mesh of the world: the
    one-GPU step's reading (loss, embeddings, gradients whole, launches)
    and this rank's state bytes at rest."""
    from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.parallel.mesh import make_mesh
    from atq_tpu_torch.parallel.sharded_model import ShardedModel
    from atq_tpu_torch.train.retrieval import (
        RetrievalConfig,
        _batch_to,
        build_retrieval_train_step,
    )

    out = {}
    for name, conf in spec["configs"].items():
        experts = conf.get("moe", 0)
        model = ATQMultimodalRetrieval(
            vocab_size=spec["vocab"], embed_dim=192, hidden_dim=384,
            use_residual=True, max_seq_length=SEQ_LEN, dropout=0.0,
            text_moe_experts=experts, device="cpu")
        model.load_state_dict(spec["state"][experts])
        model.to(device)
        mesh = make_mesh(conf["dp"], conf.get("tp", 1))
        sharded = ShardedModel(model, mesh, fsdp=conf.get("fsdp", False))
        cfg = RetrievalConfig(**spec["cfg"][experts])
        criterion = HardNegativeMiningInfoNCE(lambda_reg=cfg.contrastive_reg)
        criterion.set_epoch(0, cfg.epochs)
        step = build_retrieval_train_step(model, _NoUpdate(), criterion, cfg,
                                          None, None, mesh, sharded)
        b = _batch_to(spec["batch"][experts], device)
        _reset_launches()
        loss = step(b, torch.tensor(criterion.get_current_temperature(),
                                    device=device),
                    torch.tensor(0, device=device))
        launches = kernel_launches()
        tensors = [t for _, t in sharded.optim_params]
        grads = sharded.to_full([t.grad if t.grad is not None
                                 else torch.zeros_like(t) for t in tensors])
        sharded.gather()
        with torch.no_grad(), mesh.data_shard():
            img, txt = model(*(mesh.rows(t) for t in b),
                             return_embeddings=True, train=True)
            img, txt = mesh.gather_rows(img), mesh.gather_rows(txt)
        names = [n for n, _ in model.named_parameters()]
        out[name] = {
            "reading": (float(loss), img.double().cpu(), txt.double().cpu(),
                        {n: g.detach().double().cpu()
                         for n, g in zip(names, grads)}, launches),
            "state_bytes": sharded.state_bytes()}
        del model, sharded, grads
        torch.cuda.empty_cache()
    return out


def scale_out_checks(spec_path, out_path, backend):
    """Worker (every rank): step 0 of the spec's configs, then the parallel
    library, over the world (``backend`` nccl, a card a rank, or gloo, the
    ranks sharing card 0); rank 0 writes both."""
    import torch.distributed as dist

    from atq_tpu_torch.utils.platform import resolve_device

    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                       if backend == "nccl" else 0)
    resolve_device(dev)  # TF32 off
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    spec = torch.load(spec_path, weights_only=False)
    out = {"step0": _scale_step0(spec, dev),
           "library": _scale_library(dev, backend)}
    _rank0_write(out_path, out)
    dist.destroy_process_group()


def scale_out_runs(spec_path, out_path):
    """Worker (every rank): each of the spec's trainer runs in turn, ``(name,
    kind, argv)`` with ``kind`` retrieval or classifier, main() with the
    counts reset before it and read after it; rank 0 writes each run's
    throughput, losses, step times, launches a step and state bytes."""
    from atq_tpu_torch.ops import kernel_launches

    out = {}
    for name, kind, argv in torch.load(spec_path, weights_only=False):
        _reset_launches()
        t0 = time.perf_counter()
        if kind == "retrieval":
            from atq_tpu_torch.train.retrieval import main as retrieval_main

            state, _, report = retrieval_main(list(argv))
            stats = state["stats"]
            rate = {"pairs_per_s": stats["pairs_per_sec"],
                    "report_pairs_per_s": report["pairs_per_sec"]}
            losses, per_step = (stats["step_losses"],
                                stats["launches_per_step"])
            sharded, opt = state["sharded"], state["optimizer"]
            seconds, step_ms = stats["epoch_seconds"], stats["step_ms"]
        else:
            from atq_tpu_torch.train.__main__ import main as train_main

            state, results = train_main(list(argv))
            rate = {"imgs_per_s": results["imgs_per_sec"]}
            losses, per_step = (results["step_losses"],
                                results["launches_per_step"])
            sharded, opt = state["sharded"][0], state["atq_opt"]
            seconds, step_ms = results["epoch_seconds"], results["step_ms"]
        moments = sum(t.numel() * t.element_size()
                      for k in opt.MOMENTS for t in getattr(opt, k))
        out[name] = {
            **rate, "epoch_seconds": seconds,
            "wall_s": time.perf_counter() - t0,
            "step_ms_p50": [float(np.percentile(t[1:], 50))
                            for t in step_ms],
            "step_losses": losses, "launches_per_step": per_step,
            "launches": kernel_launches(), "state_bytes": sharded.state_bytes(),
            "moment_bytes": moments}
        del state
        torch.cuda.empty_cache()
    _rank0_write(out_path, out)


def _scale_library(dev, backend):
    """The parallel library over the world on ``dev``, each result against
    the one-process port on the same card: the largest differences over
    the ranks and moe_ffn_sharded's launches."""
    import torch.distributed as dist

    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.parallel import collectives as C
    from atq_tpu_torch.parallel.mesh import make_mesh
    from atq_tpu_torch.parallel.moe import moe_ffn, moe_ffn_sharded
    from atq_tpu_torch.parallel.pipeline import pipeline_apply
    from atq_tpu_torch.parallel.ring_attention import (
        dense_reference_attention,
        ring_attention,
    )
    from atq_tpu_torch.serve.index import EmbeddingIndex

    mesh = make_mesh()
    group, n, me = mesh.group("data"), mesh.shape["data"], mesh.index("data")
    gen = torch.Generator().manual_seed(5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    out, diffs = {"backend": backend, "world": n}, {}

    def diff(name, got, want):
        diffs[name] = max(diffs.get(name, 0.0),
                          (got - want).abs().max().item())

    # Collectives: the negative pool's gather and its backward.
    emb, emb_g = randn(SCALE_ROWS * n, 192), randn(SCALE_ROWS * n, 192)
    local = mesh.rows(emb).clone().requires_grad_()
    gathered = C.all_gather_embeddings(local, group)
    (gathered * emb_g).sum().backward()
    diff("all_gather_embeddings", gathered, emb)
    diff("all_gather_embeddings_grad", local.grad, n * mesh.rows(emb_g))

    # moe_ffn_sharded: 8 ternary experts at the text tower's widths.
    d, h = 192, 384
    x_all = randn(MOE_ROWS * n, d)
    g_all = randn(MOE_ROWS * n, d)
    params = {"gate": randn(d, MOE_EXPERTS, scale=d ** -0.5),
              "w1": randn(MOE_EXPERTS, d, h, scale=d ** -0.5),
              "w2": randn(MOE_EXPERTS, h, d, scale=h ** -0.5)}
    cap = math.ceil(MOE_ROWS / MOE_EXPERTS * 1.25)
    e_local = MOE_EXPERTS // n
    mine = slice(me * e_local, (me + 1) * e_local)
    x = mesh.rows(x_all).clone().requires_grad_()
    p = {"gate": params["gate"].clone().requires_grad_(),
         "w1": params["w1"][mine].clone().requires_grad_(),
         "w2": params["w2"][mine].clone().requires_grad_()}
    _reset_launches()
    y, aux = moe_ffn_sharded(x, p, group, cap, ternary=True,
                             sparsity_target=0.1)
    out["moe_launches"] = kernel_launches()
    ((y * mesh.rows(g_all)).sum() + aux["aux_loss"]).backward()
    whole = {k: v.clone().requires_grad_() for k, v in params.items()}
    xs = x_all.clone().requires_grad_()
    total, ys, auxes = 0.0, [], []
    for r in range(n):  # the one-process port, shard by shard
        rows = slice(r * MOE_ROWS, (r + 1) * MOE_ROWS)
        yr, ar = moe_ffn(xs[rows], whole, cap, ternary=True,
                         sparsity_target=0.1)
        total = total + (yr * g_all[rows]).sum() + ar["aux_loss"]
        ys.append(yr)
        auxes.append(ar["aux_loss"])
    total.backward()
    diff("moe_y", y, ys[me])
    diff("moe_aux", aux["aux_loss"], torch.stack(auxes).mean())
    diff("moe_dx", x.grad, mesh.rows(xs.grad))
    diff("moe_dw1", p["w1"].grad, whole["w1"].grad[mine])
    diff("moe_dw2", p["w2"].grad, whole["w2"].grad[mine])
    dgate = C.all_reduce_(p["gate"].grad.clone(), group)
    diff("moe_dgate", dgate, whole["gate"].grad)

    # The row-sharded search, float32 and int8.
    corpus = randn(1000, 192).cpu().numpy()
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = randn(8, 192).cpu().numpy()
    for quantize in ("none", "int8"):
        index = EmbeddingIndex(dim=192, capacity=1024, quantize=quantize,
                               device=dev)
        index.add([f"c{i}" for i in range(1000)], corpus)
        want_ids, want = index.search(queries, k=10)
        ids, got = index.search(queries, k=10, mesh=mesh)
        if ids != want_ids:
            raise AssertionError(f"sharded search ({quantize}): ids differ")
        diff("search_" + quantize, torch.from_numpy(got),
             torch.from_numpy(want))

    # Ring attention over the group's sequence blocks. Gloo carries no
    # point-to-point exchange of CUDA tensors (its send of one fails), so
    # over gloo the ring and the pipeline run on host tensors.
    p2p = dev if backend == "nccl" else torch.device("cpu")
    out["p2p_device"] = str(p2p)
    b, heads, blk, dh = 16, 8, 64, 24
    q, k, v, g = (randn(b, heads, blk * n, dh).to(p2p) for _ in range(4))
    pad = torch.zeros((b, blk * n), dtype=torch.bool, device=p2p)
    pad[0, -5:] = True

    def block(t, dim):
        return C.shard_rows(t.transpose(0, dim), me, n).transpose(0, dim)

    ql, kl, vl = (block(t, 2).clone().requires_grad_() for t in (q, k, v))
    o = ring_attention(ql, kl, vl, group, block(pad, 1))
    (o * block(g, 2)).sum().backward()
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    oa = dense_reference_attention(qa, ka, va, pad)
    (oa * g).sum().backward()
    diff("ring_o", o, block(oa, 2))
    for name, got, want in (("dq", ql, qa), ("dk", kl, ka),
                            ("dv", vl, va)):
        diff("ring_" + name, got.grad, block(want.grad, 2))

    # The pipeline: one stage a rank.
    w, bias = (randn(n, 192, 192, scale=192 ** -0.5).to(p2p),
               randn(n, 192).to(p2p))
    px, pg = randn(64, 192).to(p2p), randn(64, 192).to(p2p)
    stage = {"w": w.clone().requires_grad_(),
             "b": bias.clone().requires_grad_()}
    py = pipeline_apply(lambda s, t: torch.tanh(t @ s["w"] + s["b"]), stage,
                        px, group=group, n_micro=8)
    (py * pg).sum().backward()
    ws, bs = w.clone().requires_grad_(), bias.clone().requires_grad_()
    hseq = px
    for s in range(n):
        hseq = torch.tanh(hseq @ ws[s] + bs[s])
    (hseq * pg).sum().backward()
    diff("pipeline_y", py, hseq)
    diff("pipeline_dw", stage["w"].grad[me], ws.grad[me])
    diff("pipeline_db", stage["b"].grad[me], bs.grad[me])

    all_diffs = [None] * n
    dist.all_gather_object(all_diffs, diffs)
    out["max_abs_diff"] = {k: max(dd[k] for dd in all_diffs) for k in diffs}
    return out


def phase_scale_out(tmp):
    """Phase scale_out (module docstring)."""
    n = torch.cuda.device_count()
    # The checks' world: N cards over NCCL, or two ranks on the one card
    # over gloo (NCCL takes one rank a card).
    backend, world = ("nccl", n) if n >= 2 else ("gloo", 2)
    t0 = time.perf_counter()
    configs = {f"dp{world}": {"dp": world},
               f"dp{world}_fsdp": {"dp": world, "fsdp": True}}
    if n >= 4:
        configs.update({"dp2_tp2_fsdp": {"dp": n // 2, "tp": 2,
                                         "fsdp": True},
                        f"dp{n}_moe8": {"dp": n, "moe": MOE_EXPERTS}})
    spec = {"configs": configs, "state": {}, "batch": {}, "cfg": {}}
    one, envelope = {}, {}
    for experts in sorted({c.get("moe", 0) for c in configs.values()}):
        model, batch, cfg = _retrieval_step0_setup(
            tmp, n=SCALE_ROWS * world, moe_experts=experts)
        spec["state"][experts] = model.state_dict()
        spec["batch"][experts] = batch
        spec["cfg"][experts] = dataclasses.asdict(cfg)
        spec["vocab"] = model.text_encoder.embedding.weight.shape[0]
        one[experts] = _retrieval_step0(model, batch, cfg, "cuda", False)
        envelope[experts] = [
            _retrieval_step0(model, (batch[0] * np.float32(1 + e),)
                             + tuple(batch[1:]), cfg, "cuda", False)
            for e in (1e-6, -1e-6)]
        del model
    spec_path = os.path.join(tmp, "scale_spec.pt")
    torch.save(spec, spec_path)
    checks_out = os.path.join(tmp, "scale_checks.pt")
    checks_s = _torchrun(world, ["--scale-out-checks", spec_path,
                                 checks_out, backend])
    emit({"phase": "scale_out_checks", "seconds": time.perf_counter() - t0,
          "torchrun_s": checks_s})
    got = torch.load(checks_out, weights_only=False)
    step0 = {}
    for name, conf in configs.items():
        want, env = one[conf.get("moe", 0)], envelope[conf.get("moe", 0)]
        reading = got["step0"][name]["reading"]
        step0[name] = _scale_compare(name, reading, want, env)
        _check_launches(f"scale_out {name} step 0", reading[4], want[4])
        step0[name]["launches"] = reading[4]
        step0[name]["state_bytes"] = got["step0"][name]["state_bytes"]
        try:
            _scale_compare("planted", _planted(reading, "alpha"), want, env)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"scale_out {name}: the planted fault "
                                 "(every dα dropped) passed")
    library = got["library"]
    bad = {k: v for k, v in library["max_abs_diff"].items()
           if not v <= LIBRARY_TOL}
    if bad:
        raise AssertionError(f"scale_out library past {LIBRARY_TOL}: {bad}")
    if library["moe_launches"]["batched_order_stat"] != 2:
        raise AssertionError("moe_ffn_sharded: batched order statistic "
                             f"launches {library['moe_launches']}")

    # The trainers through torchrun, one launch for every run.
    recipe = SCALE_TRAIN_ARGV + ["--batch_size", str(SCALE_ROWS * n),
                                 "--synthetic_images",
                                 str(4 * n * SCALE_STEPS), "--data_dir",
                                 os.path.join(tmp, "no_flickr8k")]
    train = {f"dp{n}": ["--dp", str(n)]}
    if n >= 2:  # one rank has nothing to shard
        train[f"dp{n}_fsdp"] = ["--dp", str(n), "--fsdp"]
    if n >= 4:
        train.update({"dp2_tp2_fsdp": ["--dp", str(n // 2), "--tp", "2",
                                       "--fsdp"],
                      f"dp{n}_moe8": ["--dp", str(n), "--moe_experts",
                                      str(MOE_EXPERTS)]})
    runs_spec = [(name, "retrieval", recipe + flags
                  + ["--output_dir", os.path.join(tmp, name)])
                 for name, flags in train.items()]
    runs_spec.append(("classifier", "classifier", SCALE_CLASSIFIER_ARGV + [
        "--batch-size", str(256 * n), "--dp", str(n), "--device", "cuda",
        "--checkpoint-dir", os.path.join(tmp, "scale_classifier"),
        "--plots-dir", os.path.join(tmp, "scale_plots")]))
    runs_path = os.path.join(tmp, "scale_runs_spec.pt")
    torch.save(runs_spec, runs_path)
    runs_out = os.path.join(tmp, "scale_runs.pt")
    runs_s = _torchrun(n, ["--scale-out-runs", runs_path, runs_out])
    runs = torch.load(runs_out, weights_only=False)
    for name, run in runs.items():
        # Steady rate: the global batch over the median step after the
        # first (an 8-step epoch's own rate is mostly its set-up).
        rows = 256 * n if name == "classifier" else SCALE_ROWS * n
        run["steady_per_s"] = [rows / (t / 1000.0)
                               for t in run["step_ms_p50"]]
        _scale_run_checks(name, run, step0.get(name))
    emit({"phase": "scale_out", "cards": n, "backend": "nccl",
          "checks_backend": backend, "checks_world": world,
          "checks": [f"step0 {k}" for k in sorted(step0)] + ["library"]
          + [f"run {k}" for k in sorted(runs)],
          "step0": step0, "library": library, "checks_torchrun_s": checks_s,
          "runs": runs, "runs_torchrun_s": runs_s,
          "seconds": time.perf_counter() - t0})
    return dict(runs[f"dp{n}"]["launches"])


def _scale_compare(what, got, want, env):
    """A sharded step-0 reading ``got`` against the one-GPU ``want``
    (comment above SCALE_ENVELOPE); ``env``: the one-GPU step on the
    images scaled by 1 ± 1e-6. Returns the readings (each leaf group's
    worst error over its limit), raising past a limit."""
    k = SCALE_ENVELOPE
    rel = abs(got[0] - want[0]) / abs(want[0])
    emb = max((a - b).abs().max().item() for a, b in zip(got[1:3],
                                                         want[1:3]))
    env_rel = max(abs(e[0] - want[0]) / abs(want[0]) for e in env)
    env_emb = max((a - b).abs().max().item() for e in env
                  for a, b in zip(e[1:3], want[1:3]))
    limits = {"loss": max(RET_LOSS_RTOL, k * env_rel),
              "embeddings": max(RET_EMBED_ATOL, k * env_emb)}
    scale = max(g.abs().max().item() for g in want[3].values())
    worst, elem = {}, 0.0
    for n, g in want[3].items():
        err = (got[3][n] - g).norm().item()
        elem = max(elem, (got[3][n] - g).abs().max().item() / scale)
        if g.abs().max().item() <= RET_ROUNDING * scale:
            continue
        moved = max((e[3][n] - g).norm().item() for e in env)
        ratio = err / (RET_LEAF_TOL_CPU[_leaf_group(n, g)] * g.norm().item()
                       + k * moved)
        group = _leaf_group(n, g)
        if ratio >= worst.get(group, ("", -1.0))[1]:
            worst[group] = (n, ratio)
    out = {"loss": got[0], "loss_rel_diff": rel,
           "embedding_max_abs_diff": emb, "limits": limits,
           "leaf_error_over_limit": worst,
           "grad_max_abs_diff_over_max": elem}
    if rel > limits["loss"] or emb > limits["embeddings"] or any(
            v > 1.0 for _, v in worst.values()):
        raise AssertionError(f"{what} step 0 past its limits: "
                             f"{json.dumps(out)}")
    return out


def _scale_run_checks(name, run, step0):
    """A short epoch under torchrun: finite losses, the order statistic
    launched every step, the launches a step those of its step 0."""
    losses = [x for epoch in run["step_losses"] for x in epoch]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"scale_out {name}: losses {losses}")
    per_step = run["launches_per_step"][0]
    if per_step.get("order_stat", 0) <= 0:
        raise AssertionError(f"scale_out {name}: no order statistic "
                             f"launched ({per_step})")
    if step0 is not None:
        _check_launches(f"scale_out {name} epoch", per_step,
                        step0["launches"])


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--time-tree"]:
        time_tree(*argv[1:])  # before importing this tree's atq_tpu_torch
        return 0
    if argv[:1] == ["--compare"]:
        compare(*argv[1:])
        return 0
    if argv[:1] == ["--encoder-step0"]:
        encoder_step0_readings(*argv[1:])  # before importing atq_tpu_torch
        return 0
    if argv[:1] == ["--traced-aot"]:
        from atq_tpu_torch.utils.platform import resolve_device

        resolve_device("cuda")
        traced_aot(*argv[1:])
        return 0
    workers = {"--scale-out-checks": scale_out_checks,
               "--scale-out-runs": scale_out_runs}
    if argv[:1] and argv[0] in workers:  # a torchrun rank of scale_out
        os.environ["ATQ_NO_DOWNLOAD"] = "1"
        workers[argv[0]](*argv[1:])
        return 0
    from atq_tpu_torch.utils.platform import resolve_device

    readings_modes = {"--retrieval-step0": retrieval_step0_readings,
                      "--retrieval-amp-step0": retrieval_amp_step0_readings,
                      "--retrieval-scan-step0":
                          lambda tmp: scan_step0_readings(tmp)[0],
                      "--amp-modules": lambda tmp: amp_module_readings(
                          tmp, AMP_MODULE_SEEDS, again=True,
                          cpu_threads=(1,))}
    if argv[:1] and argv[0] in readings_modes:
        resolve_device("cuda")
        os.environ["ATQ_NO_DOWNLOAD"] = "1"
        phase_build(_smi())
        with tempfile.TemporaryDirectory() as tmp:
            readings = readings_modes[argv[0]](tmp)
        if len(argv) > 1:
            with open(argv[1], "w") as f:
                json.dump(readings, f, indent=1)
        return 0
    from atq_tpu_torch.data.mnist import synthetic_test_set

    resolve_device("cuda")  # TF32 off for the cuDNN convs and matmuls
    os.environ["ATQ_NO_DOWNLOAD"] = "1"  # the synthetic data; no network
    smi = _smi()
    phase_build(smi)
    if argv[:1] == ["--scale-out"]:  # the build and scale_out alone
        with tempfile.TemporaryDirectory() as tmp:
            phase_scale_out(tmp)
        print(smi, flush=True)
        return 0
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
        phase_packed_classifier(path, images, packed)
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
        def drill():
            t = time.perf_counter()
            return _drill(tmp), time.perf_counter() - t

        aot_launches, drill_result = phase_serve_aot(
            path, ret_path, tmp, images, refs[True], req, ret_ref, drill)
        batch = _step0_batch()
        cpu_step0 = _step0("cpu", False, batch)
        _, dense_step0 = phase_train("train_dense", False, tmp, batch,
                                     cpu_step0)
        fused_launches, _ = phase_train("train_fused", True, tmp, batch,
                                        dense_step0)
        phase_encoder_step0()
        encoder_launches = phase_train_encoder(tmp)
        phase_train_retrieval(tmp)
        eval_launches = phase_evaluate(
            os.path.join(tmp, "train_dense", "atq_model_fashion_mnist.npz"),
            os.path.join(tmp, "retrieval_train", "best_model.npz"), tmp)
        phase_train_retrieval_scan(tmp)
        phase_train_retrieval_amp(tmp, drill_result)
        moe_launches = phase_train_retrieval_moe(tmp)
        phase_resnet_rewrites()
        scale_launches = phase_scale_out(tmp)

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
                        "device_ms": t["kernel_device_ms"],
                        "evaluate_launches": eval_launches.get(name, 0),
                        "moe_launches": moe_launches.get(name, 0),
                        "scale_out_launches": scale_launches.get(name, 0),
                        "serve_aot_launches": aot_launches.get(name, 0)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
