"""Ternary transformer encoder layer and scanned stack (port of
atq_tpu/nn/transformer.py).

- :class:`TernaryTransformerLayer`: pre-norm; every layer is "critical"
  (attention precision 0.2, FFN linear1/linear2 0.2/0.4); one learnable
  sigmoid gate (init 0.8) scales both residual branches; exact GELU. With
  ``moe_experts > 0`` the FFN is the ternary-expert MoE
  (parallel/moe.py): ``moe_gate`` (D, E), ``moe_w1`` (E, D, F) and
  ``moe_w2`` (E, F, D) in place of ``linear1``/``linear2``, capacity
  ``max(1, ceil(tokens / E · moe_capacity_factor))``, padding tokens left
  out of the routing, the experts ternarized at the layer's
  ``sparsity_target``. It computes in the dtype ``norm2`` gives it
  (float32), as in JAX. Where JAX sows each layer's load-balance loss into
  'intermediates', the caller passes a list as ``moe_aux`` and each MoE
  layer appends its loss to it: nothing is kept on the module, so a
  rematerialized forward appends to the list of its own call.
- :class:`ScannedTernaryStack`: L layers whose parameters and 'quant'
  buffers are kept STACKED, with a leading L axis, under
  ``scan.layer.*`` as the JAX ``nn.scan`` layout keeps them; the hoisted
  pass (nn/hoist.py) reads the (L, out, in) tensors as they lie. Each step
  unbinds them once and runs one layer at a time through
  ``torch.func.functional_call`` on a structure-only copy of the layer.
  Remat checkpoints each layer (``torch.utils.checkpoint``,
  non-reentrant):

  - 'save_quantized' (default): the effective weights are computed outside
    the checkpointed layer (hoisted for all layers, or per layer), so the
    backward reuses them and recomputes only the activations. On the fused
    path (``ATQ_FUSED=1``, not hoisted) each projection runs the fused op
    inside the checkpoint, as in JAX, and only its threshold is computed
    outside;
  - 'save_dots': the same, and the projection products' outputs are saved
    too (a selective-checkpoint policy on ``aten.mm``/``aten.addmm``);
  - 'full': the whole layer, quantizer included, is recomputed.

  Under AMP the carry stays in the compute dtype between layers.

:func:`normalize_checkpoint` turns a JAX-layout retrieval checkpoint whose
text stack is scanned (``text_encoder/layers/scan/layer``) into the
unrolled ``layers_{i}`` layout that serving runs, as the JAX package's
serve.py does for every checkpoint; :func:`normalize_text_encoder_layout`
does it for one text-encoder subtree.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from atq_tpu_torch.nn.attention import (
    LayerNorm32,
    TernaryMultiheadAttention,
    _proj,
    lengths_to_padding_mask,
)
from atq_tpu_torch.nn.hoist import effective_weights, thresholds
from atq_tpu_torch.nn.initializers import normal_std_
from atq_tpu_torch.nn.layers import _QuantizedLinear, _use_fused, dropout
from atq_tpu_torch.parallel.collectives import active_data_shard
from atq_tpu_torch.parallel.moe import moe_ffn
from atq_tpu_torch.utils.platform import resolve_device

REMAT_POLICIES = ("save_quantized", "save_dots", "full")


class TernaryTransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 layer_idx: int = 0, grad_mode: str = "parity", dtype=None,
                 attn_impl: str = "einsum", moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25,
                 pre_quantized: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.layer_idx = layer_idx
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_sparsity = sparsity_target
        initial_sparsity = min(0.1, sparsity_target)
        ratio = 0.2  # every layer is critical (layer_idx >= 0)
        self.gate = nn.Parameter(torch.full((1,), 0.8))
        self.norm1 = LayerNorm32(embed_dim)
        self.self_attn = TernaryMultiheadAttention(
            embed_dim, num_heads, dropout=dropout, use_rpb=use_rpb,
            sparsity_target=initial_sparsity, critical_attention=True,
            grad_mode=grad_mode, dtype=dtype, attn_impl=attn_impl,
            pre_quantized=pre_quantized, device="cpu", generator=generator)
        self.norm2 = LayerNorm32(embed_dim)
        if moe_experts > 0:
            e, d, f = moe_experts, embed_dim, dim_feedforward
            self.moe_gate = nn.Parameter(normal_std_(
                torch.empty(d, e), d ** -0.5, generator))
            self.moe_w1 = nn.Parameter(normal_std_(
                torch.empty(e, d, f), d ** -0.5, generator))
            self.moe_w2 = nn.Parameter(normal_std_(
                torch.empty(e, f, d), f ** -0.5, generator))
        else:
            self.linear1 = _proj(use_rpb, embed_dim, dim_feedforward, ratio,
                                 initial_sparsity, grad_mode, dtype,
                                 pre_quantized, generator)
            self.linear2 = _proj(use_rpb, dim_feedforward, embed_dim,
                                 ratio * 2, initial_sparsity, grad_mode,
                                 dtype, pre_quantized, generator)
        self.to(resolve_device(device))

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                moe_aux: Optional[List[torch.Tensor]] = None):
        """``generator`` draws the dropout masks when not
        ``deterministic``; an MoE layer appends its load-balance loss to
        ``moe_aux`` when given."""
        def drop(x):
            return dropout(x, self.dropout, deterministic, generator)

        gate = torch.sigmoid(self.gate)
        src2 = self.norm1(src)
        src2 = self.self_attn(src2, src2, src2, attn_mask=src_mask,
                              key_padding_mask=src_key_padding_mask,
                              deterministic=deterministic,
                              generator=generator)
        src = src + drop(src2) * gate
        src2 = self.norm2(src)
        if self.moe_experts > 0:
            src2 = self._moe_ffn(src2, src_key_padding_mask, moe_aux)
        else:
            h = drop(F.gelu(self.linear1(src2)))
            src2 = self.linear2(h)
        return src + drop(src2) * gate

    def _moe_ffn(self, x, key_padding_mask, moe_aux):
        """The MoE FFN over the flattened (B·L, D) tokens; padding tokens
        (``key_padding_mask`` True, or past a lengths vector) are not
        routed."""
        b, length, d = x.shape
        tokens = b * length
        # A data-parallel rank routes its block of the global token set, at
        # the global batch's capacity (parallel/moe.py ``_route``).
        shard = active_data_shard()
        capacity = moe_capacity(tokens * (shard.count if shard else 1),
                                self.moe_experts, self.moe_capacity_factor)
        token_mask = None
        if key_padding_mask is not None:
            pad = torch.as_tensor(key_padding_mask, device=x.device)
            if pad.ndim == 1:  # lengths, as the attention takes them
                pad = lengths_to_padding_mask(pad, length)
            token_mask = torch.logical_not(pad.bool()).reshape(tokens)
        y, aux = moe_ffn(x.reshape(tokens, d),
                         {"gate": self.moe_gate, "w1": self.moe_w1,
                          "w2": self.moe_w2},
                         capacity=capacity, ternary=True,
                         sparsity_target=self.moe_sparsity,
                         token_mask=token_mask)
        if moe_aux is not None:
            moe_aux.append(aux["aux_loss"])
        return y.reshape(b, length, d)


def moe_capacity(tokens, experts: int, factor: float):
    """``max(1, ceil(tokens / experts · factor))`` in double precision, as
    JAX computes it. The ceiling is ``trunc`` plus one where a remainder
    is left: ops that ``torch.export`` can save when ``tokens`` follows a
    symbolic batch (``math.ceil`` and ``max`` are not among them)."""
    v = tokens / experts * factor
    t = math.trunc(v)
    return torch.sym_max(1, torch.sym_ite(v > t, t + 1, t))


def _tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers by name."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def structure_copies(layer: nn.Module):
    """``(plain, pre_quantized)``: two structure-only (meta) copies of a
    layer, for ``functional_call`` with tensors given per call."""
    plain = copy.deepcopy(layer).to("meta")
    preq = copy.deepcopy(plain)
    for m in preq.modules():
        if isinstance(m, _QuantizedLinear):
            m.pre_quantized = True
    return plain, preq


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _fused(template) -> bool:
    """Whether the layer's projections take the fused path
    (nn/layers.py), which is read per call, as the layers read it."""
    return any(isinstance(m, _QuantizedLinear) and m.grad_mode != "ttq"
               and _use_fused(m.fused, m.dtype) for m in template.modules())


def _tensor_parallel(template) -> bool:
    """Whether the layer's projections hold out-features shards
    (parallel/sharded_model.py sets their ``tp``)."""
    return any(getattr(m, "tp", None) is not None
               for m in template.modules())


def run_layer(plain, preq, tensors, h, kwargs, grad_mode: str, dtype,
              remat: bool, remat_policy: str, quantized: bool):
    """One layer on ``tensors`` (its parameters and buffers by name).
    ``quantized``: the effective weights are already in ``tensors`` (the
    hoisted pass). Otherwise 'save_quantized' and 'save_dots' under remat
    quantize here, outside the checkpoint, and run the layer pre-quantized,
    or on the fused path compute only the thresholds here and run the
    plain layer, whose fused ops take them; 'full' and no remat run the
    plain layer, quantizer included. Under tensor parallelism the plain
    layer runs whatever the policy: each projection takes its threshold
    from its gathered weight (nn/layers.py), which a shard alone cannot
    give."""
    if not quantized and remat and remat_policy != "full" \
            and not _tensor_parallel(plain):
        if _fused(plain):
            tensors = {**tensors, **thresholds(tensors)}
        else:
            tensors = {**tensors, **effective_weights(
                tensors, grad_mode, dtype, batched=False)}
            quantized = True
    template = preq if quantized else plain
    if not remat:
        return functional_call(template, tensors, (h,), kwargs)
    # torch.utils.checkpoint replays the global RNGs, not a caller's
    # generator: the recompute sets the dropout generator back to the
    # layer's start, so it draws the forward's masks, and then returns it
    # to where the stream was (also when the recompute stops early), so
    # the recompute draws nothing from it.
    generator = None if kwargs.get("deterministic", True) \
        else kwargs.get("generator")
    start = generator.get_state() if generator is not None else None
    calls = []

    def body(t, x):
        if start is None:
            return functional_call(template, t, (x,), kwargs)
        recompute = bool(calls)
        calls.append(1)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return functional_call(template, t, (x,), kwargs)
        finally:
            if recompute:
                generator.set_state(resume)

    if remat_policy == "save_dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return checkpoint(body, tensors, h, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(body, tensors, h, use_reentrant=False)


class _Holder(nn.Module):
    """Owner of the stacked tensors (``scan.layer.*``)."""


class ScannedTernaryStack(nn.Module):
    """``num_layers`` TernaryTransformerLayers with stacked parameters
    (atq_tpu/nn/transformer.py:133-257). Each layer is initialised as the
    unrolled layer would be, then the layers' tensors are stacked."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 use_rpb: bool = True, sparsity_target: float = 0.3,
                 grad_mode: str = "parity", dtype=None,
                 attn_impl: str = "einsum", remat: bool = True,
                 remat_policy: str = "save_quantized",
                 hoist_quant: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}")
        self.num_layers = num_layers
        self.grad_mode, self.dtype = grad_mode, dtype
        self.remat, self.remat_policy = remat, remat_policy
        self.hoist_quant = hoist_quant
        layers = [TernaryTransformerLayer(
            embed_dim, num_heads, dim_feedforward=dim_feedforward,
            dropout=dropout, use_rpb=use_rpb,
            sparsity_target=sparsity_target, layer_idx=0,
            grad_mode=grad_mode, dtype=dtype, attn_impl=attn_impl,
            device="cpu", generator=generator) for _ in range(num_layers)]
        # Structure-only copies: not registered, so never in state_dict().
        self._templates = structure_copies(layers[0])
        holder = layers[0]
        stacked = {name: torch.stack([_tensors(lyr)[name] for lyr in layers])
                   for name in _tensors(holder)}
        params = dict(holder.named_parameters())
        for name, t in stacked.items():
            *path, leaf = name.split(".")
            mod = holder.get_submodule(".".join(path))
            if name in params:
                setattr(mod, leaf, nn.Parameter(t))
            else:
                mod._buffers[leaf] = t
        self.scan = _Holder()
        self.scan.layer = holder
        self.to(resolve_device(device))

    def forward(self, h, src_mask=None, src_key_padding_mask=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        tensors = _tensors(self.scan.layer)
        if self.hoist_quant:
            if _tensor_parallel(self._templates[0]):
                raise NotImplementedError(
                    "hoisted quantization of out-features shards: the "
                    "thresholds need the gathered weights")
            tensors = {**tensors, **effective_weights(
                tensors, self.grad_mode, self.dtype, batched=True)}
        per_layer = {name: t.unbind(0) for name, t in tensors.items()}
        kwargs = {"src_mask": src_mask,
                  "src_key_padding_mask": src_key_padding_mask,
                  "deterministic": deterministic, "generator": generator}
        if self.dtype is not None:
            h = h.to(self.dtype)
        plain, preq = self._templates
        for i in range(self.num_layers):
            y = run_layer(plain, preq,
                          {name: ts[i] for name, ts in per_layer.items()},
                          h, kwargs, self.grad_mode, self.dtype, self.remat,
                          self.remat_policy, quantized=self.hoist_quant)
            # The layer returns float32; the carry keeps one dtype.
            h = y.to(h.dtype)
        return h


def stack_layer_params(state: Dict[str, torch.Tensor], num_layers: int,
                       prefix: str = "layers_",
                       dest: str = "layers") -> Dict[str, torch.Tensor]:
    """Unrolled ``{prefix}{i}.*`` entries of a flat state dict -> the
    scanned layout ``{dest}.scan.layer.*``, each leaf stacked on a new
    leading axis (atq_tpu/nn/transformer.py:260-283)."""
    heads = [f"{prefix}{i}." for i in range(num_layers)]
    missing = [h[:-1] for h in heads if not any(k.startswith(h)
                                               for k in state)]
    if missing:
        raise ValueError(f"unrolled layer entries missing: {missing}")
    leaves = sorted(k[len(heads[0]):] for k in state
                    if k.startswith(heads[0]))
    out = {k: v for k, v in state.items()
           if not any(k.startswith(h) for h in heads)}
    for leaf in leaves:
        out[f"{dest}.scan.layer.{leaf}"] = torch.stack(
            [state[h + leaf] for h in heads])
    return out


def unstack_layer_params(state: Dict[str, torch.Tensor], num_layers: int,
                         prefix: str = "layers_",
                         dest: str = "layers") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params`."""
    head = f"{dest}.scan.layer."
    if not any(k.startswith(head) for k in state):
        raise ValueError(f"no scanned entries '{head}*' in the state dict")
    out = {k: v for k, v in state.items() if not k.startswith(head)}
    for k, v in state.items():
        if k.startswith(head):
            for i in range(num_layers):
                out[f"{prefix}{i}.{k[len(head):]}"] = v[i]
    return out


def is_scanned_text_layout(tree, dest: str = "layers") -> bool:
    """True when a text-encoder collection subtree uses the scanned
    (``layers/scan/layer``) layout."""
    node = tree.get(dest) if isinstance(tree, dict) else None
    return isinstance(node, dict) and "scan" in node


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _scanned_num_layers(subtree, dest: str = "layers") -> int:
    """The layer count of a scanned subtree: its stacked leaves' leading
    axis."""
    leaves = [v for k, v in _flatten(subtree).items()
              if k.startswith(f"{dest}.scan.")]
    if not leaves:
        raise ValueError("scanned subtree has no leaves")
    return int(leaves[0].shape[0])


def _unroll(subtree, dest: str = "layers"):
    """A scanned text-encoder subtree (nested dict of arrays) unrolled
    through :func:`unstack_layer_params`; the layer count is the stacked
    leaves' leading axis."""
    return _unflatten(unstack_layer_params(
        _flatten(subtree), _scanned_num_layers(subtree, dest), dest=dest))


def normalize_text_encoder_layout(params_te: dict, quant_te: dict,
                                  num_layers: Optional[int] = None):
    """A text-encoder subtree (nested dicts of arrays) in the unrolled
    ``layers_{i}`` layout that evaluation and serving run: a scanned one
    is unrolled, ``quant_te`` too when it is scanned. The layer count is
    read off the stacked leaves; ``num_layers``, when given, must equal
    it. Returns ``(params_te, quant_te, was_scanned)``; an unrolled input
    comes back as it is."""
    if not is_scanned_text_layout(params_te):
        return params_te, quant_te, False
    derived = _scanned_num_layers(params_te)
    if num_layers is not None and num_layers != derived:
        raise ValueError(f"scanned checkpoint has {derived} layers, caller "
                         f"expected {num_layers}")
    if is_scanned_text_layout(quant_te):
        quant_te = _unroll(quant_te)
    return _unroll(params_te), quant_te, True


def normalize_checkpoint(ckpt: dict):
    """A retrieval checkpoint (nested dict of arrays) with its
    ``text_encoder`` subtrees (params, quant, ema_params) converted from
    the scanned to the unrolled layout. Returns ``(ckpt, was_scanned)``;
    the input is not mutated."""
    params = ckpt.get("params", {})
    te = params.get("text_encoder") if isinstance(params, dict) else None
    if not is_scanned_text_layout(te):
        return ckpt, False
    out = dict(ckpt)
    for coll in ("params", "quant", "ema_params"):
        tree = ckpt.get(coll)
        if isinstance(tree, dict) and is_scanned_text_layout(
                tree.get("text_encoder")):
            out[coll] = {**tree, "text_encoder": _unroll(tree["text_encoder"])}
    return out, True
