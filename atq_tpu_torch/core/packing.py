"""Planar 2-bit ternary packing (PyTorch port of atq_tpu/core/packing.py).

Encoding: -1 -> 00, 0 -> 01, +1 -> 10. The K axis is zero-padded to a
multiple of ``k_align`` (512) and split into 4 contiguous quarters of
``kq = K_pad / 4`` bytes; byte b of a row holds the values of columns
(b, kq+b, 2kq+b, 3kq+b) in bit fields (0-1, 2-3, 4-5, 6-7). The bytes are
identical to ``atq_tpu.core.packing.pack_planar``.

``pack_planar32`` stores the same 2-bit codes in int32 words, 16 fields a
word (K padded to a multiple of 2048); its words are bit-identical to
``atq_tpu.core.packing.pack_planar32``, the negative ones included.

``TernaryBitPacking.pack_ternary_weights`` packs the reference's flat
format (the flattened N·K stream, four values a byte, padding that decodes
as -1) and ``pack_rows`` keeps each row's bytes apart ((N, ceil(K/4)),
padding that decodes as 0); both are byte-identical to the JAX package's.
"""

from __future__ import annotations

import torch

_TERNARY = (-1.0, 0.0, 1.0)


def _check_ternary(ternary_weights: torch.Tensor) -> None:
    """Raise unless every value is -1, 0 or +1 (the validation of the
    reference packer). Reads the values back to the host: export-time
    use only."""
    allowed = torch.tensor(_TERNARY, dtype=ternary_weights.dtype,
                           device=ternary_weights.device)
    if not bool(torch.isin(ternary_weights, allowed).all()):
        raise ValueError("Input must contain only ternary values (-1, 0, 1)")


_SHIFTS = (0, 2, 4, 6)


def _fields(packed: torch.Tensor) -> torch.Tensor:
    """The four 2-bit fields of each byte, on a new last axis."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    return (packed[..., None] >> shifts) & 0x3


def pack_planar(ternary_weights: torch.Tensor,
                k_align: int = 512) -> torch.Tensor:
    """Pack a 2-D ternary (N, K) matrix into (N, K_pad/4) uint8 planes."""
    if ternary_weights.ndim != 2:
        raise ValueError(f"pack_planar takes a 2-D (N, K) matrix, got shape "
                         f"{tuple(ternary_weights.shape)}")
    _check_ternary(ternary_weights)
    return pack_planar_unchecked(ternary_weights, k_align)


def pack_planar_unchecked(ternary_weights: torch.Tensor,
                          k_align: int = 512) -> torch.Tensor:
    """:func:`pack_planar` without the ternary check, so without a read
    back to the host: for values decoded from packed bytes on the device
    (the ``rows`` layout's conversion in ops/ternary_matmul.py)."""
    out_features, in_features = ternary_weights.shape
    k_pad = (-in_features) % k_align
    w = torch.nn.functional.pad(ternary_weights, (0, k_pad), value=0.0)
    kq = w.shape[1] // 4
    quarters = (w + 1).to(torch.uint8).reshape(out_features, 4, kq)
    return (quarters[:, 0]
            | (quarters[:, 1] << 2)
            | (quarters[:, 2] << 4)
            | (quarters[:, 3] << 6)).contiguous()


def unpack_planar(packed: torch.Tensor, in_features: int,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_planar` (drops the K padding)."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    quarters = (packed[:, None, :] >> shifts[None, :, None]) & 0x3
    full = quarters.reshape(packed.shape[0], -1)
    return full[:, :in_features].to(dtype) - 1.0


def pack_planar32(ternary_weights: torch.Tensor,
                  k_align: int = 2048) -> torch.Tensor:
    """Pack a 2-D ternary (N, K) matrix into (N, K_pad/16) int32 words.

    K is zero-padded to a multiple of ``k_align`` and split into 16
    contiguous sixteenths of ``k16 = K_pad / 16`` columns; bit field f
    (bits 2f..2f+1) of word j holds column ``f·k16 + j``. A +1 in field 15
    sets bit 31, so the words are built in int64 and wrapped to int32
    explicitly (``<<`` on int32 past bit 31 is not something to lean on).
    """
    if ternary_weights.ndim != 2:
        raise ValueError(f"pack_planar32 takes a 2-D (N, K) matrix, got "
                         f"shape {tuple(ternary_weights.shape)}")
    _check_ternary(ternary_weights)
    out_features, in_features = ternary_weights.shape
    k_pad = (-in_features) % k_align
    w = torch.nn.functional.pad(ternary_weights, (0, k_pad), value=0.0)
    k16 = w.shape[1] // 16
    fields = (w + 1).to(torch.int64).reshape(out_features, 16, k16)
    shifts = torch.arange(16, dtype=torch.int64, device=w.device) * 2
    words = (fields << shifts[None, :, None]).sum(dim=1)  # disjoint bits
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).contiguous()


# Encoded all-zeros word for padding rows of a planar32 matrix: every 2-bit
# field 0b01 (the encoding of 0).
PLANAR32_ZERO_WORD = 0x55555555


def unpack_planar32(packed: torch.Tensor, in_features: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_planar32` (drops the K padding). ``>>`` on
    int32 is arithmetic; the mask after it keeps only the field."""
    shifts = torch.arange(16, dtype=torch.int32, device=packed.device) * 2
    fields = (packed[:, None, :] >> shifts[None, :, None]) & 0x3
    full = fields.reshape(packed.shape[0], -1)
    return full[:, :in_features].to(dtype) - 1.0


def pack_rows(ternary_weights: torch.Tensor) -> torch.Tensor:
    """Pack a 2-D ternary (N, K) matrix row by row into (N, ceil(K/4))
    uint8: value j of a row in bits 2·(j % 4) of byte j / 4, K padded
    with zeros (which decode as 0). Not checked for ternary values, as in
    the JAX package."""
    out_features, in_features = ternary_weights.shape
    w = torch.nn.functional.pad(ternary_weights, (0, (-in_features) % 4),
                                value=0.0)
    mapped = (w + 1).to(torch.uint8).reshape(out_features, -1, 4)
    return (mapped[..., 0] | (mapped[..., 1] << 2) | (mapped[..., 2] << 4)
            | (mapped[..., 3] << 6)).contiguous()


def unpack_flat(packed: torch.Tensor, num_values: int,
                dtype=torch.float32) -> torch.Tensor:
    """The first ``num_values`` values of a flat 2-bit stream (the
    reference format), as a 1-D tensor."""
    return _fields(packed).reshape(-1)[:num_values].to(dtype) - 1.0


def unpack_rows(packed: torch.Tensor, in_features: int,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_rows` (drops the K padding)."""
    flat = _fields(packed).reshape(packed.shape[0], -1)[:, :in_features]
    return flat.to(dtype) - 1.0


class TernaryBitPacking:
    """Pack and unpack ternary weights in the reference's flat 2-bit
    format, and the savings report of ``train.py --bit-packing``."""

    @staticmethod
    def pack_ternary_weights(ternary_weights: torch.Tensor) -> dict:
        """Pack a {-1, 0, +1} tensor of any shape into
        ``{"packed_weights": uint8[ceil(n/4)], "original_shape",
        "metadata": {"num_values", "encoding"}}``. The trailing fields of
        the last byte are 0 (decode as -1), as in the reference; unpacking
        drops them by ``num_values``. Raises on a value other than -1, 0,
        +1 (read back to the host: export-time use only)."""
        ternary_weights = torch.as_tensor(ternary_weights)
        _check_ternary(ternary_weights)
        flat = ternary_weights.reshape(-1)
        num_values = flat.numel()
        mapped = (flat + 1).to(torch.uint8)
        mapped = torch.nn.functional.pad(mapped, (0, (-num_values) % 4))
        quads = mapped.reshape(-1, 4)
        packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                  | (quads[:, 3] << 6))
        return {"packed_weights": packed.contiguous(),
                "original_shape": tuple(ternary_weights.shape),
                "metadata": {"num_values": num_values,
                             "encoding": {0: -1, 1: 0, 2: 1}}}

    @staticmethod
    def unpack_ternary_weights(packed_data: dict,
                               dtype=torch.float32) -> torch.Tensor:
        """Inverse of :meth:`pack_ternary_weights`."""
        return unpack_flat(torch.as_tensor(packed_data["packed_weights"]),
                           packed_data["metadata"]["num_values"],
                           dtype).reshape(packed_data["original_shape"])

    @staticmethod
    def fast_ternary_matmul(packed_data: dict, input_tensor: torch.Tensor,
                            alpha=1.0) -> torch.Tensor:
        """``input @ unpack(W)ᵀ · alpha`` from the flat format: the
        ``flat`` layout of ops/ternary_matmul.py (the packed kernel on the
        card) where the shapes are kernel-eligible, otherwise unpack and
        ``torch.matmul``, as the JAX method routes."""
        from atq_tpu_torch.ops.ternary_matmul import (
            kernel_eligible,
            packed_ternary_matmul,
        )

        shape = tuple(packed_data["original_shape"])
        if (len(shape) == 2 and input_tensor.ndim == 2
                and kernel_eligible(tuple(input_tensor.shape), shape)):
            return packed_ternary_matmul(
                input_tensor, packed_data["packed_weights"], shape, alpha,
                layout="flat")
        weights = TernaryBitPacking.unpack_ternary_weights(
            packed_data, dtype=input_tensor.dtype)
        return torch.matmul(input_tensor, weights.T) * alpha

    @staticmethod
    def compute_memory_savings(original_tensor) -> dict:
        """Theoretical savings of 2-bit packing against float32."""
        n = int(original_tensor.numel())
        original_bytes = n * 4
        packed_bytes = (n * 2 + 7) // 8
        return {
            "original_bytes": original_bytes,
            "packed_bytes": packed_bytes,
            "compression_ratio": original_bytes / packed_bytes,
            "memory_reduction": 1.0 - (packed_bytes / original_bytes),
        }
