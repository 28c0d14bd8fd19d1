"""Quantized layers (port of atq_tpu/nn)."""
