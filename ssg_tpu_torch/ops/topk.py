"""Exact min-k / max-k over rows.

Counterpart of ``ssg_tpu/ops/topk.py``. The JAX package's block-min
prefilter is TPU tuning and is not ported: ``torch.topk`` is exact. The
contract is the returned VALUE multiset in sorted order; which index is
returned among tied values is arbitrary on both sides.
"""

from __future__ import annotations

import torch


def exact_min_k(key: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of each row's k smallest, ascending."""
    k = min(int(k), key.shape[-1])
    return torch.topk(key, k, dim=-1, largest=False, sorted=True)


def exact_max_k(key: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of each row's k largest, descending."""
    k = min(int(k), key.shape[-1])
    return torch.topk(key, k, dim=-1, largest=True, sorted=True)
