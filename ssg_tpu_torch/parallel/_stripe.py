"""Stripe primitives of the streaming pipeline, on one device.

Counterparts of the ``ssg_tpu/parallel/ring.py`` primitives that
``parallel/streaming.py`` calls. There a device holds a row stripe of each
(N, N) state and the primitives rotate the other stripes past it over the
mesh; on one device the stripe is the whole matrix, so each primitive is
its local computation. They keep the mesh names so that a multi-GPU
version (NCCL, ``torch.distributed``) can replace this module without
touching the pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch

from ssg_tpu_torch.ops.bits import pack_bits, unpack_bits


def ring_pairwise(a: torch.Tensor, b: torch.Tensor,
                  pair_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """(r_a, N) tile ``pair_fn(a, B)`` over every row of B, fp32."""
    return pair_fn(a, b).float()


def ring_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (r_a, N) @ b (N, M), fp32. For 0/1 bf16 operands (its only uses)
    the counts are at most k1 + 1, exact in bf16, and cuBLAS accumulates in
    fp32, as JAX's ``precision=None`` product."""
    return (a @ b).float()


def ring_gather_sum(idx: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_t b[idx[i, t]], accumulated t-ascending from zeros, as
    the mesh form accumulates within a visit; fp32."""
    acc = torch.zeros((idx.shape[0], b.shape[1]), dtype=torch.float32, device=b.device)
    for t in range(idx.shape[1]):
        acc += b[idx[:, t]]
    return acc


# Output rows a block of the packed transpose (a multiple of 8).
_TRANSPOSE_BLOCK = 1024


def stripe_transpose_packed(x: torch.Tensor) -> torch.Tensor:
    """Bit-packed (N, N // 8) boolean A -> packed A^T, _TRANSPOSE_BLOCK
    output rows at a time: the bool transient is one (N, block) slab, never
    the unpacked matrix."""
    n = x.shape[0]
    out = torch.empty_like(x)
    for i0 in range(0, n, _TRANSPOSE_BLOCK):
        i1 = min(i0 + _TRANSPOSE_BLOCK, n)
        out[i0:i1] = pack_bits(unpack_bits(x[:, i0 // 8:i1 // 8], i1 - i0).T)
    return out
