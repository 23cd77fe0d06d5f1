"""Stripe primitives of the streaming pipeline.

Counterparts of the ``ssg_tpu/parallel/ring.py`` primitives that
``parallel/streaming.py`` calls. On a mesh of more than one rank each call
goes to ``parallel/ring.py``, where a rank holds a row stripe of each
(N, N) state and the other stripes rotate past it. On a mesh of one (or
``mesh=None``) the stripe is the whole matrix, so each primitive is its
local computation.
"""

from __future__ import annotations

from typing import Callable

import torch

from ssg_tpu_torch.parallel import ring


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def ring_pairwise(a: torch.Tensor, b: torch.Tensor,
                  pair_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  mesh=None) -> torch.Tensor:
    """(r_a, N) tile ``pair_fn(a, B)`` over every row of B, fp32."""
    if _multi(mesh):
        return ring.ring_pairwise(mesh, a, b, pair_fn)
    return pair_fn(a, b).float()


def ring_contract(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """a (r_a, N) @ B (N, M), fp32. For 0/1 bf16 operands (its only uses)
    the counts are at most k1 + 1, exact in bf16, and cuBLAS accumulates in
    fp32, as JAX's ``precision=None`` product."""
    if _multi(mesh):
        return ring.ring_contract(mesh, a, b)
    return (a @ b).float()


def stripe_transpose_packed(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Bit-packed row stripe of boolean A -> packed stripe of A^T."""
    return ring.stripe_transpose_packed(mesh, x)
