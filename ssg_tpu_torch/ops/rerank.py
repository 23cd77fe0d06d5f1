"""k-reciprocal re-ranking as fixed-shape matrix operations.

Counterpart of ``ssg_tpu/ops/rerank.py`` (Zhong et al., CVPR 2017,
arXiv:1701.08398), step for step:

  rank lists       -> one exact top-k(k1 + 1); the k1/2 list is its prefix
  reciprocity      -> boolean mask intersection  R = M & M^T
  2/3-overlap      -> |R(i) & Rh(c)| = (R Rh^T)[i, c]   (bf16 0/1 GEMM)
  set-union expand -> (Q Rh)[i, k] > 0                   (bf16 0/1 GEMM)
  query expansion  -> one-hot(topk2) @ V / k2            (fp32 GEMM, TF32 off)
  Jaccard min-sum  -> (S_i + S_j - ||V_i - V_j||_1) / 2  (CUDA L1 kernel)

The 0/1 products are exact in bf16: every count is at most k1 + 1, far
below bf16's 256 exact integers, and cuBLAS accumulates in fp32.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.l1 import l1_distance
from ssg_tpu_torch.ops.topk import exact_min_k


def _membership(indices: torch.Tensor, n: int) -> torch.Tensor:
    """(N, k) index lists -> (N, N) boolean membership mask."""
    mask = torch.zeros((n, n), dtype=torch.bool, device=indices.device)
    return mask.scatter_(1, indices, True)


def _count_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of 0/1 matrices as exact fp32 counts (bf16 operands)."""
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()


def _encode(original_dist: torch.Tensor, k1: int, k2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(normalised distance, query-expanded sparse encoding V), both (N, N)."""
    n = original_dist.shape[0]

    # Canonical preamble: column-max normalise, transpose (oracle parity).
    col_max = original_dist.amax(0).clamp_min(1e-12)
    orig = (original_dist / col_max).T.contiguous()

    # Sorted top-k: the k1/2 list is a prefix of the k1 list. Python's
    # round is half-to-even, as in the JAX package.
    half = int(round(k1 / 2.0))
    _, nn1 = exact_min_k(orig, k1 + 1)
    m1 = _membership(nn1, n)
    mh = _membership(nn1[:, :half + 1], n)
    r = m1 & m1.T  # k-reciprocal sets R(i, k1)
    rh = mh & mh.T  # R(i, k1/2)

    # Candidate expansion: |R(i) & Rh(c)| > 2/3 |Rh(c)| for c in R(i).
    overlap = _count_product(r, rh.T)
    sz = rh.float().sum(1)
    qualify = r & (overlap > (2.0 / 3.0) * sz[None, :])
    expanded = r | (_count_product(qualify, rh) > 0.0)

    # Gaussian-weighted sparse encoding, row-normalised; a row whose
    # reciprocal set is empty yields zeros, not NaNs.
    w = torch.where(expanded, torch.exp(-orig), 0.0)
    v = w / w.sum(1, keepdim=True).clamp_min(1e-30)

    # Local query expansion over the k2 nearest neighbours (one-hot GEMM).
    if k2 != 1:
        nn2 = nn1[:, :k2] if k2 <= k1 + 1 else exact_min_k(orig, k2)[1]
        v = (_membership(nn2, n).float() @ v) / float(k2)

    return orig, v


def _re_ranking_impl(original_dist: torch.Tensor, k1: int, k2: int,
                     lambda_value: float, l1_impl: str = "auto") -> torch.Tensor:
    orig, v = _encode(original_dist, k1, k2)

    # Jaccard via the L1 identity: sum_k min(a, b) = (S_a + S_b - |a - b|_1) / 2.
    s = v.sum(1)
    l1 = l1_distance(v, impl=l1_impl)
    min_sum = 0.5 * (s[:, None] + s[None, :] - l1)
    jaccard = 1.0 - min_sum / (2.0 - min_sum)
    final = jaccard * (1.0 - lambda_value) + orig * lambda_value
    return final.clamp_min(0.0)


def re_ranking(features=None, dist=None, k1: int = 20, k2: int = 6,
               lambda_value: float = 0.1, l1_impl: str = "auto",
               device=None) -> torch.Tensor:
    """k-reciprocal re-ranked (N, N) distance matrix, fp32 on ``device``.

    Either ``features`` (N, D) or a precomputed Euclidean ``dist`` (N, N)
    must be given (tensors or numpy arrays).
    """
    dev = resolve_device(device)
    if dist is None:
        if features is None:
            raise ValueError("re_ranking: need features or dist")
        original = pairwise_distance(torch.as_tensor(features, device=dev))
    else:
        original = torch.as_tensor(dist, device=dev).float().square()
    n = original.shape[0]
    # Neighbourhood sizes cannot exceed N - 1 on tiny inputs.
    k1 = min(int(k1), n - 1)
    k2 = min(int(k2), n - 1)
    return _re_ranking_impl(original, k1, k2, float(lambda_value), l1_impl)
