"""The work the re-ranking's L1 Jaccard needs for a given encoding V.

V (N, N) is non-negative, so the pairwise L1 that the Jaccard reads is
``S_i + S_j - 2 sum_k min(V_ik, V_jk)``: the work needed is, for each
column k with c_k nonzero rows, its c_k (c_k - 1) / 2 pairs (a min and an
add each), plus the per-pair combine (three operations) of the N (N - 1) / 2
pairs, all plain fp32 operations (no FMA form). The bytes needed are V's
nonzeros read once (a value and a column index, 4 bytes each) and the
(N, N) fp32 distance written once. Whatever implements it, a sparse min-sum
or the dense kernel, these inputs need this much; the dense count
(``chip_smoke.l1_bound_ms``, 2 N^3) is the most a kernel could do, not
what V needs.
"""

from __future__ import annotations

from benchmark.frozen.peaks import FP32_NON_FMA_PER_S, HBM_BYTES_PER_S


def work(col_counts, n: int) -> tuple[float, float]:
    """(operations, bytes) from V's column counts (a sequence of ints or a
    1-D tensor) and its size N."""
    c = [int(x) for x in col_counts]
    pairs = sum(x * (x - 1) // 2 for x in c)
    ops = 2.0 * pairs + 3.0 * n * (n - 1) / 2
    nbytes = 8.0 * sum(c) + 4.0 * n * n
    return ops, nbytes


def bound_s(col_counts, n: int) -> float:
    """Least seconds the chip could take: the larger of operations over the
    plain fp32 rate and bytes over HBM bandwidth."""
    ops, nbytes = work(col_counts, n)
    return max(ops / FP32_NON_FMA_PER_S, nbytes / HBM_BYTES_PER_S)
