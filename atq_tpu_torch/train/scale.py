"""QAT step of the ternary BERT-class encoder at production shapes.

Port of benchmarks/scale_mfu.py: a full quantization-aware training step,
token embedding -> N TernaryTransformerLayers (RPB projections with a
per-step threshold from the order statistic, STE gradients) -> final
LayerNorm -> mean-pool -> dense head over 1000 classes, softmax CE, AdamW
1e-4 (weight decay 1e-4 on every parameter, optax.adamw's order). AMP is
the JAX package's: bf16 matmuls in the layers, float32 everywhere else.

    python -m atq_tpu_torch.train.scale --configs bert-base --attn fused --hoist

runs bert-base (embed 768, FFN 3072, 12 heads, 12 layers, sequence 256,
batch 64, remat, scanned) on the card; with ``--attn fused --hoist`` each
step runs the batched order statistic once per weight kind and the fused
attention forward and backward once per layer (the forward twice under
remat). It writes one JSON row per configuration (``--out``), as the JAX
harness does. ``--device`` defaults to ``cuda`` and raises without a GPU.

Kept from the JAX harness: the unrolled branch (``scan=False``, the
ref-scale anchor) ignores ``--attn``; the final LayerNorm has flax's
default eps 1e-6; the embedding runs in the compute dtype; tokens and
labels come from ``np.random.RandomState(0)`` in the same order.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.nn.initializers import embed_default_, lecun_normal_
from atq_tpu_torch.nn.transformer import (
    ScannedTernaryStack,
    TernaryTransformerLayer,
    _tensors,
    run_layer,
    structure_copies,
)
from atq_tpu_torch.train.classifier import AdamChain
from atq_tpu_torch.utils.flops import counted_flops, mfu
from atq_tpu_torch.utils.platform import resolve_device
from atq_tpu_torch.utils.timing import steady_state_sec_per_step

# name: (embed, ffn, heads, layers, seq, batch, remat, scan)
CONFIGS = {
    "ref-scale": (128, 512, 8, 4, 50, 256, False, False),
    "bert-base": (768, 3072, 12, 12, 256, 64, True, True),
    "bert-large": (1024, 4096, 16, 24, 256, 32, True, True),
    "wide-2k": (2048, 8192, 16, 8, 128, 32, True, True),
}
VOCAB = 32000
N_CLASSES = 1000
LEARNING_RATE = WEIGHT_DECAY = 1e-4


def analytic_step_flops(embed, ffn, heads, layers, seq, batch):
    """Matmul FLOPs for one training step (fwd + bwd = 3 x forward): per
    layer 4 E^2 (qkv+out) and 2 E F (FFN) over B*S tokens plus the
    2 B S^2 E attention pair, then the head. Remat's recompute and
    elementwise work are not counted."""
    tokens = batch * seq
    per_layer = (2 * tokens * (4 * embed * embed + 2 * embed * ffn)
                 + 4 * batch * seq * seq * embed)
    fwd = layers * per_layer + 2 * batch * embed * N_CLASSES
    return 3.0 * fwd


class Encoder(nn.Module):
    """The harness's encoder, with flax's auto-names (``Embed_0``,
    ``layers`` or ``layer_{i}``, ``LayerNorm_0``, ``Dense_0``)."""

    def __init__(self, embed, ffn, heads, layers, remat, scan, dtype=None,
                 grad_mode="ste", remat_policy="save_quantized",
                 attn_impl="einsum", hoist_quant=False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.scan, self.remat = dtype, scan, remat
        self.grad_mode, self.remat_policy = grad_mode, remat_policy
        self.num_layers = layers
        self.Embed_0 = nn.Embedding(VOCAB, embed)
        embed_default_(self.Embed_0.weight, generator=generator)
        kw = dict(dim_feedforward=ffn, dropout=0.0, use_rpb=True,
                  sparsity_target=0.3, grad_mode=grad_mode, dtype=dtype,
                  device="cpu", generator=generator)
        if scan:
            self.layers = ScannedTernaryStack(
                layers, embed, heads, remat=remat, remat_policy=remat_policy,
                attn_impl=attn_impl, hoist_quant=hoist_quant, **kw)
        else:
            for i in range(layers):
                setattr(self, f"layer_{i}", TernaryTransformerLayer(
                    embed, heads, layer_idx=i, **kw))
            self._templates = structure_copies(self.layer_0)
        self.LayerNorm_0 = nn.LayerNorm(embed, eps=1e-6)  # flax's default
        self.Dense_0 = nn.Linear(embed, N_CLASSES)
        lecun_normal_(self.Dense_0.weight, generator=generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, tokens):
        x = self.Embed_0(tokens)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.scan:
            x = self.layers(x, deterministic=True)
        else:
            plain, preq = self._templates
            for i in range(self.num_layers):
                layer = getattr(self, f"layer_{i}")
                if self.remat:
                    x = run_layer(plain, preq, _tensors(layer), x,
                                  {"deterministic": True}, self.grad_mode,
                                  self.dtype, True, self.remat_policy,
                                  quantized=False)
                else:
                    x = layer(x, deterministic=True)
        x = self.LayerNorm_0(x.float())
        return self.Dense_0(x.mean(dim=1))


def build_step(embed, ffn, heads, layers, seq, batch, remat, scan,
               use_amp=True, grad_mode="ste", remat_policy="save_quantized",
               attn_impl="einsum", hoist_quant=False, device=None, seed=0):
    """``(step, step_fn, state, n_params)`` as the JAX harness returns
    them; ``state`` is ``(model, optimizer)`` and ``step(state)`` returns
    ``(state, loss)`` with the loss left on the device. ``seed`` draws the
    batch and the init (the harness's is 0)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if use_amp else None
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (batch, seq))).to(device)
    labels = torch.from_numpy(rng.randint(0, N_CLASSES, (batch,))).to(device)
    model = Encoder(embed, ffn, heads, layers, remat, scan, dtype=dtype,
                    grad_mode=grad_mode, remat_policy=remat_policy,
                    attn_impl=attn_impl, hoist_quant=hoist_quant,
                    generator=torch.Generator().manual_seed(seed)).to(device)
    opt = AdamChain(model.named_parameters(), lambda _: LEARNING_RATE,
                    decoupled_weight_decay=WEIGHT_DECAY)
    n_params = sum(p.numel() for p in model.parameters())

    def step(state):
        model, opt = state
        for p in model.parameters():
            p.grad = None
        loss = F.cross_entropy(model(tokens), labels.long())
        loss.backward()
        opt.step()
        return state, loss.detach()

    return step, step, (model, opt), n_params


def measure(name, spec, use_amp=True, iters=8, remat_policy="save_quantized",
            attn_impl="einsum", hoist_quant=False, device=None, warmup=2):
    """One JSON row: the JAX harness's keys, plus the device, every step's
    loss, kernel launches per timed step and the peak device memory. In
    place of XLA's cost analysis (``flops_per_step_xla``) the row has
    ``flops_per_step_counted``: the first warm-up step counted by
    utils/flops.py ``counted_flops`` (products and convolutions, the
    kernels' included; None when ``warmup`` is 0), beside the analytic
    ``flops_per_step`` that the MFU uses."""
    from atq_tpu_torch.ops import kernel_launches

    device = resolve_device(device)
    embed, ffn, heads, layers, seq, batch, remat, scan = spec
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step, step_fn, state, n_params = build_step(
        embed, ffn, heads, layers, seq, batch, remat, scan,
        use_amp=use_amp, remat_policy=remat_policy, attn_impl=attn_impl,
        hoist_quant=hoist_quant, device=device)
    losses = []
    counts = {}
    counted = {}

    def recorded(state):
        if len(losses) == warmup:  # first timed step
            counts.update(kernel_launches())
        if not losses and warmup > 0:  # the first warm-up step, counted
            flops, (state, loss) = counted_flops(lambda: step_fn(state))
            counted.update(flops)
        else:
            state, loss = step_fn(state)
        losses.append(loss)
        return state, loss

    dt, state = steady_state_sec_per_step(recorded, state, warmup=warmup,
                                          iters=iters, device=device)
    launches = {k: (v - counts[k]) / iters
                for k, v in kernel_launches().items()}
    flops = analytic_step_flops(embed, ffn, heads, layers, seq, batch)
    device_name = (torch.cuda.get_device_name(device) if on_cuda
                   else "cpu")
    util = mfu(flops, dt, device_name)
    row = {
        "config": name, "embed": embed, "ffn": ffn, "heads": heads,
        "layers": layers, "seq": seq, "batch": batch, "remat": remat,
        "scan": scan, "use_amp": use_amp,
        "remat_policy": remat_policy if (remat and scan) else None,
        "attn_impl": attn_impl,
        "hoist_quant": bool(hoist_quant and scan),
        "params_millions": n_params / 1e6,
        "ms_per_step": dt * 1000,
        "tokens_per_sec": batch * seq / dt,
        "flops_per_step": flops,
        "flops_per_step_counted": counted.get("total"),
        "flops_per_step_counted_kernels": counted.get("kernels"),
        "mfu_pct": None if util is None else util * 100.0,
        "device": device_name,
        "losses": [float(x) for x in losses],
        "launches_per_step": launches,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                            if on_cuda else None),
    }
    del state
    return row


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m atq_tpu_torch.train.scale",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="outputs/scale.json")
    parser.add_argument("--quick", action="store_true",
                        help="ref-scale + bert-base only")
    parser.add_argument("--configs", nargs="*", default=None,
                        help="subset of config names to run")
    parser.add_argument("--batch", type=int, default=None,
                        help="override the configs' batch size")
    parser.add_argument("--fp32", action="store_true",
                        help="also measure fp32 rows")
    parser.add_argument("--attn", default="einsum",
                        choices=["einsum", "fused"],
                        help="attention implementation (fused = the CUDA "
                             "kernels of ops/fused_attention.py)")
    parser.add_argument("--remat-policy", default="save_quantized",
                        choices=["save_quantized", "save_dots", "full"],
                        help="scanned-stack remat policy")
    parser.add_argument("--hoist", action="store_true",
                        help="hoist quantization out of the layer loop "
                             "(nn/hoist.py): all layers' effective weights "
                             "in one batched pass per step")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--steps", type=int, default=8,
                        help="timed steps per configuration (after 2 "
                             "warm-up steps)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    names = args.configs or (["ref-scale", "bert-base"] if args.quick
                             else list(CONFIGS))
    rows = []

    def flush():
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)

    for name in names:
        for use_amp in ((True, False) if args.fp32 else (True,)):
            print(f"--- {name} amp={use_amp} ---", flush=True)
            try:
                spec = CONFIGS[name]  # inside try: a typo'd name records
                # an error row, it doesn't kill the sweep
                if args.batch is not None:
                    spec = spec[:5] + (args.batch,) + spec[6:]
                row = measure(name, spec, use_amp=use_amp, iters=args.steps,
                              remat_policy=args.remat_policy,
                              attn_impl=args.attn, hoist_quant=args.hoist,
                              device=device)
            except Exception as e:  # one row per config, as in JAX
                traceback.print_exc()
                row = {"config": name, "use_amp": use_amp,
                       "error": f"{type(e).__name__}: {e}"}
            print(row, flush=True)
            rows.append(row)
            flush()
    print(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
