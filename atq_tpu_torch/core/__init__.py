"""Quantizer and 2-bit packing (port of atq_tpu/core)."""
