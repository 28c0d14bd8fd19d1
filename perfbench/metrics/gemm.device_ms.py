"""Device ms a step in matrix-product kernels (cuBLAS and cuBLASLt with
their split-K reductions and epilogues, CUTLASS, and the
port's own ``gemm_tc_kernel``), by name; attention kernels are not
counted here."""

import re

PATTERNS = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitkreduce",
                      re.IGNORECASE)


def is_gemm(name: str, run) -> bool:
    return PATTERNS.search(name) is not None \
        and not run.metric("attn.device_ms").is_attention(name)


def read(run):
    t = run.trace
    if t is None or not any(is_gemm(n, run) for n, _, _ in t.kernels):
        return None
    return t.device_ms_per_step(lambda n: is_gemm(n, run))
