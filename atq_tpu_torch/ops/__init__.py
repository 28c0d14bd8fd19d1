"""CUDA kernel wrappers (port of atq_tpu/ops) and their build."""
