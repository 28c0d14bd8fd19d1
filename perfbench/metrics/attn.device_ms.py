"""Device ms a step in the attention layer's kernels: the port's three
fused kernels (csrc/fused_attention.cu) and PyTorch's SDPA/flash kernels,
by name."""

import re

PATTERNS = re.compile(r"attn_(fwd|bwd_rows|bwd_keys)_kernel|flash|fmha"
                      r"|attention|sdpa", re.IGNORECASE)


def is_attention(name: str) -> bool:
    return PATTERNS.search(name) is not None


def read(run):
    t = run.trace
    if t is None or not any(is_attention(n) for n, _, _ in t.kernels):
        return None
    return t.device_ms_per_step(is_attention)
