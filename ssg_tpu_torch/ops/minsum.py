"""Compacted-support min-sum: the exact Jaccard overlap for screened pairs.

Counterpart of ``ssg_tpu/ops/minsum.py``. The re-ranked distance is
fd = lam * orig + (1 - lam) * (1 - ms / (2 - ms)) with
ms = sum_k min(V_i[k], V_j[k]); V rows carry a few dozen nonzeros out of N,
and only a few pairs a row come near the eps region. The streaming
pipeline therefore screens every pair with a bound and computes the exact
ms only for the pairs the bound cannot prune:

  * ``minsum_upper``: ms <= sum over supp(V_i) of V_j[k] = B_i . V_j, one
    0/1 bf16 mask product against bf16 V on the tensor cores, inflated for
    the bf16 rounding of V and the fp32 accumulation, so the bound stays
    sound in floating point. The product must come out in fp32
    (``bound_product``): a bf16 output would round a second time, and
    (1 + 2^-9)^2 exceeds the 1 + 2^-8 inflation.
  * ``compact_rows`` / ``sparse_minsum`` / ``sparse_minsum_pairs``: exact ms
    from V rows compacted to (idx, val) lists of width S, as an S x S
    compare-select a pair. Zero-valued slots are harmless on spurious index
    matches (min(0, x) = 0), so rows whose support fits S are exact; the
    caller counts nonzeros and takes the exact fallback when a row does not.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.ops.topk import exact_max_k

# Inflation for the bf16 mask-product bound: operand rounding is <= 2^-9
# relative (round to nearest bf16), and the fp32 accumulation of the few
# nonzero terms adds far less; (1 + 2^-8) multiplicative + 1e-6 absolute
# covers both with margin (property-tested).
_INFLATE_REL = 1.0 + 2.0 ** -8
_INFLATE_ABS = 1e-6
# Cap ms_ub strictly below 2 so jac_lb = 1 - ms / (2 - ms) stays finite; the
# true ms <= min(sum V_i, sum V_j) ~ 1, so capped pairs are near-duplicates
# that stay candidates regardless.
_MS_CAP = 1.8
# Elements of one (b, qb, S, S) block of the exact correction: 2^23 fp32 is
# 32 MiB a transient, so the blocked loop takes tens of iterations a chunk
# on the card, not thousands.
_BLOCK_ELEMS = 2 ** 23


def bound_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of bf16 operands with an fp32 output, as JAX's
    ``jnp.dot(a, b.T, preferred_element_type=float32)``.

    On the card: cuBLAS's bf16 product with fp32 output (``aten::mm.dtype``,
    CUDA only; a torch without it raises here). On the CPU: the bf16-rounded
    operands multiplied in fp32 (TF32 is off, ``_device.py``), where every
    product of two bf16 values is exact and the sum is fp32, the bound's
    assumption either way.
    """
    a = a.to(torch.bfloat16)
    b = b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def support_mask(v: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """0/1 support indicator of V rows (exact in bf16)."""
    return (v > 0.0).to(dtype)


def minsum_upper(g: torch.Tensor) -> torch.Tensor:
    """Sound fp upper bound on ms from the raw mask product ``g = B_i . V_j``."""
    return (g * _INFLATE_REL + _INFLATE_ABS).clamp_max(_MS_CAP)


def fd_lower(ms_ub: torch.Tensor, orig: torch.Tensor, lambda_value: float) -> torch.Tensor:
    """Lower bound on the re-ranked distance from an upper bound on ms.

    jac = 1 - ms / (2 - ms) decreases in ms, so ms_ub gives jac_lb. The clamp
    is at the fd level only: the true jaccard can be slightly negative in fp
    (min_sum > 1 by an ulp), and the pipeline clamps final distances, not
    jaccards.
    """
    jac_lb = 1.0 - ms_ub / (2.0 - ms_ub)
    return (jac_lb * (1.0 - lambda_value) + orig * lambda_value).clamp_min(0.0)


def compact_rows(v: torch.Tensor, s_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n) fp32 -> (idx (b, s), val (b, s)): each row's s largest values.

    Captures every nonzero when the row's support fits ``s_cap``; the caller
    must check ``(v > 0).sum(1) > s_cap`` and fall back when a row overflows
    (the dropped smallest values would under-count ms).
    """
    val, idx = exact_max_k(v, min(int(s_cap), v.shape[1]))
    return idx, val


def _qblock(b: int, q: int, s: int, qblock: int | None) -> int:
    if qblock is None:
        qblock = _BLOCK_ELEMS // max(b * s * s, 1)
    return max(min(int(qblock), q), 1)


def _block_minsum(ci, cv, cj, vj) -> torch.Tensor:
    """sum over (t, u) of min(cv[t], vj[u]) where ci[t] == cj[u]; the row
    tables broadcast against (b, qb, S) column tables -> (b, qb)."""
    match = ci[..., :, None] == cj[..., None, :]
    mn = torch.minimum(cv[..., :, None], vj[..., None, :])
    return torch.where(match, mn, 0.0).sum((-2, -1))


def sparse_minsum(ci: torch.Tensor, cv: torch.Tensor, cj: torch.Tensor, vj: torch.Tensor,
                  qblock: int | None = None) -> torch.Tensor:
    """Exact ms[i, q] = sum_k min(V_i[k], V_(j_iq)[k]) from compacted rows.

    ci, cv: (b, S), row i's support indices and values. cj, vj: (b, Q, S),
    for each of Q candidate columns a row, that column's compacted row.
    Indices within a compacted row are distinct, so each (t, u) match is
    unique; zero-valued pad slots contribute min(0, x) = 0 on any match.
    Blocked over Q (``qblock`` columns a block, by default as many as keep
    one (b, qblock, S, S) block at 2^23 elements), which bounds the
    broadcast transient; the result does not depend on the blocking.
    """
    b, s = ci.shape
    q = cj.shape[1]
    qb = _qblock(b, q, s, qblock)
    out = torch.empty((b, q), dtype=torch.float32, device=cv.device)
    for q0 in range(0, q, qb):
        q1 = min(q0 + qb, q)
        out[:, q0:q1] = _block_minsum(ci[:, None], cv[:, None], cj[:, q0:q1], vj[:, q0:q1])
    return out


def sparse_minsum_pairs(ci: torch.Tensor, cv: torch.Tensor, cj: torch.Tensor, vj: torch.Tensor,
                        qblock: int | None = None) -> torch.Tensor:
    """``sparse_minsum`` where the row side also varies per slot.

    All four operands are (b, Q, S): slot q of batch row i pairs the row
    table (ci[i, q], cv[i, q]) with the column table (cj[i, q], vj[i, q]),
    the layout after streaming's cross-row slot compaction. Same semantics
    per slot as ``sparse_minsum``.
    """
    b, q, s = ci.shape
    qb = _qblock(b, q, s, qblock)
    out = torch.empty((b, q), dtype=torch.float32, device=cv.device)
    for q0 in range(0, q, qb):
        q1 = min(q0 + qb, q)
        out[:, q0:q1] = _block_minsum(ci[:, q0:q1], cv[:, q0:q1], cj[:, q0:q1], vj[:, q0:q1])
    return out
