"""Bit-packing of boolean adjacency state.

Counterpart of ``ssg_tpu/ops/bits.py``. The streaming pipeline's
persistent O(N^2) state is a boolean adjacency matrix; packing 8 columns
per uint8 byte shrinks it 8x. Consumers unpack fixed-size row chunks on
the fly, so the peak bool transient stays at chunk scale. Bit order is
LSB first throughout (``np.packbits(..., bitorder="little")``), so packed
stripes equal the JAX package's byte for byte.
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., C) bool -> (..., C // 8) uint8, LSB first. C must divide by 8."""
    c = x.shape[-1]
    xr = x.reshape(*x.shape[:-1], c // 8, 8).to(torch.uint8)
    return (xr << _shifts(x.device)).sum(-1, dtype=torch.uint8)


def unpack_bits(x: torch.Tensor, cols: int) -> torch.Tensor:
    """(..., C // 8) uint8 -> (..., C) bool, the inverse of ``pack_bits``."""
    bits = (x[..., None] >> _shifts(x.device)) & 1
    return bits.reshape(*x.shape[:-1], cols).bool()


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each byte, uint8 -> int32, by shift/mask/add steps (SWAR)."""
    x = x.to(torch.uint8)
    v = x - ((x >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return v.to(torch.int32)
