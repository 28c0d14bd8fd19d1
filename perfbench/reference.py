"""Plain float32 reference of the ternary encoder's QAT step.

What it computes, from a configuration file (perfbench/configs) and the
seeded tensors and batch of perfbench/weights.py:

    tokens -> embedding -> L pre-norm ternary layers -> LayerNorm (eps 1e-6)
    -> mean over the sequence -> dense head -> softmax cross-entropy

Each layer, with its tensors sliced from the stacked (L, ...) leaves:

    gate  = sigmoid(g)
    s     = LN1(x);  query = LN_pre(s)            (LayerNorm eps 1e-5)
    q, k, v = P_q(query), P_k(s), P_v(s)
    o     = softmax(q k^T / sqrt(d)) v            (per head, d = E / H)
    x     = x + (P_o(o) + 0.1 query) * gate
    x     = x + P_2(gelu(P_1(LN2(x)))) * gate     (exact GELU)

and each projection P(x) = x W_eff^T + b runs on the effective weight

    t     = threshold: the ascending sort of |w| at idx = floor(f32(s) f32(n))
    w_t   = +1 where w > t, -1 where w < -t, else 0
    W_eff = w_t * alpha * (1 - m) + w * m         (m: the precision mask)

with the straight-through gradient (w_t passes its gradient to w). The
step is AdamW in optax's order: ``p -= lr (m_hat / (sqrt(v_hat) + eps) +
wd p)``, bias corrections ``1 - b**t`` taken in float32.

Departures from the program (atq_tpu_torch.train.scale), each one a
reason for the tolerances in perfbench/limits:

- precision: float32 throughout with TF32 off, where the program runs the
  projections' products and the carry between layers in bfloat16 (its AMP)
  and the attention as three TF32 products;
- order: the batch runs in blocks of rows (``rows_per_block``) whose
  gradients are summed, where the program takes the batch whole, under
  remat; sums differ in order;
- the effective weights are taken once per step and their gradient
  carried back to w and alpha after the last block, where the program's
  autograd does it in one graph.

The tensor names are the program's (its ``named_parameters`` and
``named_buffers``), so that readings of both sides pair up leaf by leaf;
nothing here imports the program.

``low`` puts a rounding at every point where the program rounds to its
compute dtype: identity for the reference, and for the control
(perfbench/calibrate.py) float8 e4m3 with a per-tensor scale, forward and
backward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STACK = "layers.scan.layer."
KINDS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.out_proj", "linear1", "linear2")
NORMS = ("norm1", "self_attn.pre_layer_norm", "norm2")
B1, B2, EPS = 0.9, 0.999, 1e-8
THRESHOLD_FACTOR = 0.05


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int]:
    """``(embed, ffn, heads, layers, vocab, classes)`` of a config file."""
    return (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["num_attention_heads"], cfg["num_hidden_layers"],
            cfg["vocab_size"], cfg["num_classes"])


def kind_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """Each projection kind's (out, in)."""
    e, f = cfg["hidden_size"], cfg["intermediate_size"]
    return {**{k: (e, e) for k in KINDS[:4]}, "linear1": (f, e),
            "linear2": (e, f)}


def tensor_specs(cfg: dict) -> List[Tuple[str, tuple, torch.dtype, bool]]:
    """``(name, shape, dtype, trained)`` of every tensor of the step's
    model, by the program's names: parameters (trained) and the
    projections' mask and sparsity buffers."""
    e, _, _, n_layers, vocab, classes = dims(cfg)
    f32 = torch.float32
    specs = [("Embed_0.weight", (vocab, e), f32, True),
             (STACK + "gate", (n_layers, 1), f32, True)]
    for norm in NORMS:
        specs += [(f"{STACK}{norm}.weight", (n_layers, e), f32, True),
                  (f"{STACK}{norm}.bias", (n_layers, e), f32, True)]
    for kind, (out, inp) in kind_shapes(cfg).items():
        p = STACK + kind
        specs += [(p + ".weight", (n_layers, out, inp), f32, True),
                  (p + ".alpha", (n_layers, 1), f32, True),
                  (p + ".bias", (n_layers, out), f32, True),
                  (p + ".precision_mask", (n_layers, out, inp), torch.bool,
                   False),
                  (p + ".sparsity_target", (n_layers,), f32, False)]
    specs += [("LayerNorm_0.weight", (e,), f32, True),
              ("LayerNorm_0.bias", (e,), f32, True),
              ("Dense_0.weight", (classes, e), f32, True),
              ("Dense_0.bias", (classes,), f32, True)]
    return specs


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale (largest |x| to 448),
    forward and backward: the precision below bfloat16."""

    @staticmethod
    def _round(x):
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def forward(ctx, x):
        return _Fp8._round(x)

    @staticmethod
    def backward(ctx, g):
        return _Fp8._round(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def threshold_rank(n: int, sparsity: torch.Tensor) -> torch.Tensor:
    """``floor(f32(s) * f32(n))`` per layer, as int64."""
    n32 = torch.tensor(float(n), dtype=torch.float32, device=sparsity.device)
    return torch.floor(sparsity.float() * n32).long()


def thresholds(w: torch.Tensor, sparsity: torch.Tensor) -> torch.Tensor:
    """Per-layer quantizer thresholds (L,) of a stacked (L, out, in)
    weight: the sorted |w| at the rank, the fallback 0.05 mean|w| at rank
    0 and max|w| + 1 past the end."""
    flat = w.detach().abs().reshape(w.shape[0], -1)
    n = flat.shape[1]
    idx = threshold_rank(n, sparsity)
    ranked = torch.sort(flat, dim=1).values
    at = ranked.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0]
    fallback = THRESHOLD_FACTOR * flat.mean(dim=1)
    past = ranked[:, -1] + 1.0
    return torch.where(idx >= n, past, torch.where(idx > 0, at, fallback))


def ternary(w: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The {-1, 0, +1} pattern of a stacked weight under (L,) thresholds."""
    t = thr.reshape(-1, *([1] * (w.ndim - 1)))
    one = torch.ones((), dtype=w.dtype, device=w.device)
    return torch.where(w > t, one, torch.where(w < -t, -one,
                                               torch.zeros_like(one)))


def effective_weight(w, alpha, mask, pattern):
    """``w_t * alpha * (1 - m) + w * m`` with the straight-through
    gradient to w."""
    w_t = w + (pattern - w).detach()
    m = mask.to(w.dtype)
    a = alpha.reshape(-1, *([1] * (w.ndim - 1)))
    return (w_t * a) * (1.0 - m) + w * m


def layer_norm(x, weight, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def _project(low, x, w_eff, bias):
    return low(torch.matmul(low(x), low(w_eff).transpose(0, 1))) + bias


def forward_rows(params, w_eff, tokens, cfg, low: Callable = identity):
    """Logits (rows, classes) of a block of token rows."""
    e, _, heads, n_layers, _, _ = dims(cfg)
    d = e // heads
    eps = cfg["layer_norm_eps"]
    x = low(F.embedding(tokens, params["Embed_0.weight"]))
    rows, seq = tokens.shape
    for i in range(n_layers):
        def p(name):
            return params[STACK + name][i]

        def proj(kind, inp):
            return _project(low, inp, w_eff[kind][i], p(kind + ".bias"))

        gate = torch.sigmoid(p("gate"))
        s = layer_norm(x, p("norm1.weight"), p("norm1.bias"), eps)
        query = layer_norm(s, p("self_attn.pre_layer_norm.weight"),
                           p("self_attn.pre_layer_norm.bias"), eps)

        def split(t):
            return t.reshape(rows, seq, heads, d).transpose(1, 2)

        q = split(proj("self_attn.q_proj", query))
        k = split(proj("self_attn.k_proj", s))
        v = split(proj("self_attn.v_proj", s))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                             / math.sqrt(d), dim=-1)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(rows, seq, e)
        x = x + (proj("self_attn.out_proj", o) + 0.1 * query) * gate
        s = layer_norm(x, p("norm2.weight"), p("norm2.bias"), eps)
        hidden = F.gelu(proj("linear1", s))
        x = low(x + proj("linear2", hidden) * gate)
    x = layer_norm(x, params["LayerNorm_0.weight"],
                   params["LayerNorm_0.bias"], cfg["final_layer_norm_eps"])
    return F.linear(x.mean(dim=1), params["Dense_0.weight"],
                    params["Dense_0.bias"])


def rows_per_block(cfg: dict, seq: int, budget_bytes: float) -> int:
    """Rows whose saved activations fit ``budget_bytes``: about 20 float32
    (S, E) tensors, 4 (S, F) and 3 (H, S, S) a layer and row."""
    e, f, heads, n_layers, _, _ = dims(cfg)
    per_row = 4 * n_layers * seq * (20 * e + 4 * f + 3 * heads * seq)
    return max(1, int(budget_bytes // per_row))


class Reference:
    """The reference's state (parameters and AdamW moments, float32) and
    its step. ``tensors`` are the seeded tensors by name; the trained ones
    are copied, the buffers read as they are."""

    def __init__(self, cfg: dict, tensors: Dict[str, torch.Tensor],
                 low: Callable = identity, block_bytes: float = 16 * 2 ** 30):
        self.cfg, self.low = cfg, low
        self.block_bytes = block_bytes
        # Float32 products in float32: no TF32 on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        trained = {n for n, _, _, t in tensor_specs(cfg) if t}
        self.params = {n: tensors[n].detach().clone().requires_grad_(True)
                       for n in trained}
        self.buffers = {n: t for n, t in tensors.items() if n not in trained}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    def quantize(self):
        """Per kind: ``(thresholds (L,), pattern (L, out, in))``."""
        out = {}
        for kind in KINDS:
            w = self.params[STACK + kind + ".weight"]
            thr = thresholds(w, self.buffers[STACK + kind
                                             + ".sparsity_target"])
            out[kind] = (thr, ternary(w.detach(), thr))
        return out

    def step(self, tokens: torch.Tensor, labels: torch.Tensor,
             rows: Optional[int] = None):
        """One QAT step on the batch (or its first ``rows`` rows, the mean
        taken over them). Returns ``(loss, grads, quantized)``; the
        parameters are updated in place."""
        if rows is not None:
            tokens, labels = tokens[:rows], labels[:rows]
        quantized = self.quantize()
        w_eff = {k: effective_weight(
            self.params[STACK + k + ".weight"],
            self.params[STACK + k + ".alpha"],
            self.buffers[STACK + k + ".precision_mask"], quantized[k][1])
            for k in KINDS}
        w_leaf = {k: v.detach().requires_grad_(True) for k, v in w_eff.items()}
        for p in self.params.values():
            p.grad = None
        batch, seq = tokens.shape
        block = rows_per_block(self.cfg, seq, self.block_bytes)
        loss = torch.zeros((), dtype=torch.float64, device=tokens.device)
        for start in range(0, batch, block):
            logits = forward_rows(self.params, w_leaf,
                                  tokens[start:start + block], self.cfg,
                                  self.low)
            part = F.cross_entropy(logits, labels[start:start + block],
                                   reduction="sum") / batch
            part.backward()
            loss += part.detach().double()
        torch.autograd.backward([w_eff[k] for k in KINDS],
                                [w_leaf[k].grad for k in KINDS])
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        self._adamw(grads)
        return float(loss), grads, quantized

    @torch.no_grad()
    def _adamw(self, grads):
        self.count += 1
        bc1 = float(1.0 - np.float32(B1) ** np.float32(self.count))
        bc2 = float(1.0 - np.float32(B2) ** np.float32(self.count))
        lr, wd = self.cfg["learning_rate"], self.cfg["weight_decay"]
        for n, p in self.params.items():
            g = grads[n]
            self.mu[n].mul_(B1).add_(g, alpha=1.0 - B1)
            self.nu[n].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (self.mu[n] / bc1) / ((self.nu[n] / bc2).sqrt() + EPS)
            p.sub_(lr * (update + wd * p))
