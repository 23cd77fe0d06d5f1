"""DBSCAN over a precomputed distance matrix, with sklearn's exact labels.

Counterpart of ``ssg_tpu/cluster/dbscan.py``. sklearn's labels are three
order-free closed forms, computed here with fixed-shape matrix operations:

  * core points: |{j : d(i, j) <= eps}| >= min_samples (self included);
  * clusters are connected components of the core-core eps-graph, numbered
    in ascending order of each component's smallest core index;
  * a border point takes the adjacent core component with the smallest
    such index.

Components come from transitive-closure squaring: each round is one 0/1
bf16 GEMM (fp32 accumulation keeps nonzero-ness exact) and doubles the
path length covered, until nothing changes (one host check per round).
Each round adds one to the ``dbscan.closure_rounds`` counter of
``utils.profiling`` while spans record.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.utils.profiling import count


def dbscan(dist: torch.Tensor, eps, min_samples: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (N,) int32 with -1 for noise, number of clusters) on ``dist``'s device.

    The eps-graph ``d <= eps`` (closed ball, sklearn semantics) is
    symmetrised by OR against fp asymmetry.
    """
    n = dist.shape[0]
    dev = dist.device
    big = n
    adj = dist <= eps
    adj = adj | adj.T
    core = adj.sum(1) >= min_samples

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    reach = (adj & core[None, :] & core[:, None]) | (eye & core[:, None])
    while True:
        count("dbscan.closure_rounds")
        r16 = reach.to(torch.bfloat16)
        new = reach | ((r16 @ r16) > 0)
        if torch.equal(new, reach):
            break
        reach = new

    # Core label = smallest index in the component (sklearn discovery order).
    labels = torch.where(core, torch.where(reach, idx[None, :], big).amin(1), big)
    # Border points: the adjacent core component discovered first.
    core_neigh = torch.where(adj & core[None, :], labels[None, :], big).amin(1)
    raw = torch.where(core, labels, core_neigh)  # big -> noise

    # Renumber roots 0..C-1 in ascending-root order (= discovery order).
    is_root = core & (labels == idx)
    root_rank = torch.cumsum(is_root.int(), 0) - 1
    hit = raw < big
    out = torch.where(hit, root_rank[torch.where(hit, raw, 0).long()], -1)
    return out.int(), is_root.sum()
