"""Device ms a step in every kernel that is neither attention nor a
matrix product: quantization (the order statistic), LayerNorm, GELU,
residuals, casts, AdamW's update."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    attn = run.metric("attn.device_ms").is_attention
    gemm = run.metric("gemm.device_ms").is_gemm
    return t.device_ms_per_step(lambda n: not attn(n) and not gemm(n, run))
