"""The least time the step's attention work needs (perfbench/flops.py
``attention_work``: each layer's forward and backward once, so remat's
second forward counts as time, not work) over the attention layer's
device time, in %. The peak is TF32's when every attention kernel is a
float32 one by its name, else bf16's (the larger, so the share is never
overstated)."""

from perfbench.flops import (
    PEAK_BF16,
    PEAK_TF32,
    attention_work,
    roofline_seconds,
)


def is_float32(name: str) -> bool:
    return "bfloat16" not in name and any(
        s in name for s in ("<float", "_f32", "float32"))


def read(run):
    t = run.trace
    if t is None:
        return None
    attn = run.metric("attn.device_ms").is_attention
    names = [n for n, _, _ in t.kernels if attn(n)]
    if not names:
        return None
    f32 = all(is_float32(n) for n in names)
    cfg, traffic = run.cfg, run.traffic
    heads = cfg["num_attention_heads"]
    ops, nbytes = attention_work(traffic["batch"], heads, traffic["seq"],
                                 cfg["hidden_size"] // heads,
                                 cfg["num_hidden_layers"], 4 if f32 else 2)
    need = roofline_seconds(ops, nbytes, PEAK_TF32 if f32 else PEAK_BF16)
    spent = t.device_ms_per_step(attn) / 1e3
    return 100.0 * need / spent
