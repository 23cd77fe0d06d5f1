"""Row-sharded k-reciprocal re-ranking over a mesh of ranks.

Counterpart of ``ssg_tpu/parallel/rerank.py``. The (N, N) matrices of
``ops/rerank.py`` (the original distance, the rank masks, V, the Jaccard)
live as row stripes; the steps across rows become the ring primitives of
``parallel/ring.py``:

  reciprocity R = M & M^T         -> stripe_transpose (all-to-all)
  overlap |R(i) & Rh(c)|          -> ring_pairwise of bf16 mask products
  expansion (Q @ Rh), QE (A2 @ V) -> ring_contract (contraction sharded)
  Jaccard L1 min-sum              -> ring_pairwise of the L1 tile

On the card the L1 tile is ``ops.l1.l1_distance``, the CUDA L1 kernel
(``csrc/l1.cu``), one launch a ring visit; its plain version runs only on
the CPU. A rank holds O(N^2 / P) state. The numerics are the one-device
``re_ranking``'s (fp32, true fp32 products); the column maximum uses the
symmetry of the squared-Euclidean matrix, so the normalised transpose is
a row rescale of the stripe.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.ops.l1 import l1_distance
from ssg_tpu_torch.ops.topk import exact_min_k
from ssg_tpu_torch.parallel import ring
from ssg_tpu_torch.parallel.sharded import _global_rows, _rows_of, sqdist_stripe


def _membership_stripe(indices: torch.Tensor, npad: int) -> torch.Tensor:
    """(r, k) row index lists -> (r, npad) boolean mask."""
    out = torch.zeros((indices.shape[0], npad), dtype=torch.bool, device=indices.device)
    return out.scatter_(1, indices, True)


def _transpose_bool(mesh, m: torch.Tensor) -> torch.Tensor:
    return ring.stripe_transpose(mesh, m.to(torch.uint8)).bool()


def sharded_re_ranking(features, mesh, k1: int = 20, k2: int = 6, lambda_value: float = 0.1,
                       l1_impl: str = "auto") -> torch.Tensor:
    """Row-sharded twin of ``ops.re_ranking(features=...)``: this rank's row
    stripe (r, N) of the (N, N) re-ranked distance. ``features`` (N, D) are
    the same on every rank; the call is collective. ``l1_impl`` is
    ``ops.l1.l1_distance``'s."""
    f, f_local, n = _rows_of(features, mesh)
    return rerank_stripe(sqdist_stripe(f_local, f), n, mesh, k1, k2, lambda_value, l1_impl)


def rerank_stripe(d: torch.Tensor, n: int, mesh, k1: int = 20, k2: int = 6,
                  lambda_value: float = 0.1, l1_impl: str = "auto") -> torch.Tensor:
    """``sharded_re_ranking`` from this rank's stripe (r, P r) of the
    squared-Euclidean distance (``sqdist_stripe``; rows and columns past
    ``n`` are padding): the re-ranked stripe (r, n)."""
    r, npad = d.shape
    dev = d.device
    k1 = min(int(k1), n - 1)  # the lists cannot be longer than N
    k2 = min(int(k2), n - 1)
    half = int(round(k1 / 2.0))
    rows = _global_rows(mesh, r, dev)
    row_valid = rows[:, 0] < n
    col_valid = torch.arange(npad, device=dev) < n

    # The original squared-Euclidean stripe, column-max normalised: d is
    # symmetric, so ((D / colmax)^T)[i, :] = D[i, :] / colmax[i].
    col_max = ring.all_reduce(
        mesh, torch.where(row_valid[:, None], d, float("-inf")).amax(0), "max").clamp_min(1e-12)
    orig = d / col_max[rows[:, 0]][:, None]

    # Rank-list masks: exact_min_k returns sorted neighbours, so the k1/2
    # and k2 lists are prefixes of one selection.
    score = torch.where(col_valid[None, :], orig, float("inf"))
    nn1 = exact_min_k(score, k1 + 1)[1]
    valid2d = row_valid[:, None] & col_valid[None, :]
    m1 = _membership_stripe(nn1, npad) & valid2d
    mh = _membership_stripe(nn1[:, :half + 1], npad) & valid2d
    r_mask = m1 & _transpose_bool(mesh, m1)  # the k-reciprocal sets
    rh_mask = mh & _transpose_bool(mesh, mh)
    # 0/1 bf16 stripes with fp32 accumulation: the counts are exact.
    rf = r_mask.to(torch.bfloat16)
    rhf = rh_mask.to(torch.bfloat16)

    # The 2/3-overlap candidate expansion.
    overlap = ring.ring_pairwise(mesh, rf, rhf, lambda a, b: a @ b.T)
    sz = ring.all_gather(mesh, rh_mask.float().sum(1))
    qualify = r_mask & (overlap > (2.0 / 3.0) * sz[None, :])
    expanded = r_mask | (ring.ring_contract(mesh, qualify.to(torch.bfloat16), rhf) > 0.0)

    # Gaussian-weighted encoding + query expansion.
    w = torch.where(expanded, torch.exp(-orig), 0.0)
    v = w / w.sum(1, keepdim=True).clamp_min(1e-30)
    if k2 != 1:
        nn2 = nn1[:, :k2] if k2 <= k1 + 1 else exact_min_k(score, k2)[1]
        a2 = (_membership_stripe(nn2, npad) & valid2d).float()
        v = ring.ring_contract(mesh, a2, v) / float(k2)

    # Jaccard through the L1 min-sum identity.
    l1 = ring.ring_pairwise(mesh, v, v, lambda a, b: l1_distance(a, b, impl=l1_impl))
    s_local = v.sum(1)
    s_all = ring.all_gather(mesh, s_local)
    min_sum = 0.5 * (s_local[:, None] + s_all[None, :] - l1)
    jaccard = 1.0 - min_sum / (2.0 - min_sum)
    final = (jaccard * (1.0 - lambda_value) + orig * lambda_value).clamp_min(0.0)
    return final[:, :n]
