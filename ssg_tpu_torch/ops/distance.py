"""All-pairs (squared) Euclidean distance, fp32.

Counterpart of ``ssg_tpu/ops/distance.py``'s default path ``_pairwise_xla``:
``|x|^2 + |y|^2 - 2 x y^T`` clamped at 0, optional sqrt. The product is
``torch.matmul`` in true fp32 (TF32 off, ``_device.py``), matching the JAX
package's ``Precision.HIGHEST`` GEMM. Distances drive clustering decisions
and are never accumulated in a narrower type.
"""

from __future__ import annotations

import torch


def pairwise_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                      squared: bool = True) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) fp32; ``y`` defaults to ``x``."""
    x = x.float()
    y = x if y is None else y.float()
    x2 = (x * x).sum(1, keepdim=True)
    y2 = (y * y).sum(1, keepdim=True).T
    d = (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)
    return d if squared else d.sqrt()
