"""Parallel building blocks (port of atq_tpu/parallel).

Only the single-device mixture-of-experts FFN is here. The multi-process
scale-out (``mesh``, ``collectives``, ``multihost``, ``moe_ffn_sharded``,
``ring_attention``, ``pipeline``) is not ported yet (ROADMAP.md queue 1
item 7)."""

from atq_tpu_torch.parallel.moe import init_moe_params, moe_ffn, top1_dispatch

__all__ = ["init_moe_params", "moe_ffn", "top1_dispatch"]
