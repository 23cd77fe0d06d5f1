"""eps auto-selection (SSG's rho-quantile rule), sort-free.

Counterpart of ``ssg_tpu/cluster/eps.py``: the mean of the smallest
``round(rho * M)`` of the M nonzero upper-triangle entries, ties included,
without sorting:

  1. bisect the k-th smallest value over IEEE-754 bit patterns
     (non-negative fp32 values order like their int32 bit patterns), one
     masked count over the matrix per step, 31 steps;
  2. mean = (sum of values strictly below the k-th + the tie mass) / k.

Counts are int64, so unlike the JAX package there is no int32 limit on N.
``rho * M`` is computed in fp32 and rounded half-to-even, as JAX does, so
k is the same on both sides. The bisection stays on the device: no step
waits for the host.
"""

from __future__ import annotations

import torch

_MAX_FINITE_BITS = 0x7F7FFFFF  # largest finite fp32


def select_eps(dist: torch.Tensor, rho: float = 1.6e-3) -> torch.Tensor:
    """0-dim fp32 tensor on ``dist``'s device."""
    n = dist.shape[0]
    d = dist.float()
    valid = torch.ones((n, n), dtype=torch.bool, device=d.device).triu_(1) & (d != 0.0)

    m = valid.sum()
    rho32 = torch.tensor(rho, dtype=torch.float32, device=d.device)
    k = torch.round(rho32 * m.float()).long().clamp_min(1)

    # Invalid entries get INT32_MAX, above every candidate midpoint.
    bits = torch.where(valid, d.view(torch.int32),
                       torch.iinfo(torch.int32).max).contiguous()
    lo = torch.zeros((), dtype=torch.int64, device=d.device)
    hi = torch.full((), _MAX_FINITE_BITS, dtype=torch.int64, device=d.device)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        take_low = (bits <= mid).sum() >= k
        lo = torch.where(take_low, lo, mid + 1)
        hi = torch.where(take_low, mid, hi)
    kth = hi.to(torch.int32).view(torch.float32)

    below = valid & (d < kth)
    cnt_below = below.sum()
    sum_below = torch.where(below, d, 0.0).sum()
    total = sum_below + (k - cnt_below).float() * kth
    return total / k.float()
