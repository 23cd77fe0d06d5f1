"""SSG++ — clustering-guided semi-supervised adaptation (one-shot labels).

The port's own copy of ``ssg_tpu/train/semi.py`` (numpy only), which
rebuilds the reference's [semitraining.py] (SURVEY.md §2 #2, [HIGH that it
exists; MED on mechanism]): same skeleton as the SSG loop plus a one-shot
labeled target subset (one labeled image per identity). Mechanism implemented
here (documented design under the [MED] tag, per SURVEY.md §0.3):

  * a fixed per-part classifier head sized to the number of target
    identities is trained with cross-entropy on the labeled images;
  * cluster affiliation: a DBSCAN cluster containing exactly one one-shot
    identity donates that identity to all its members, widening the CE
    supervision each iteration (ambiguous clusters stay unsupervised, CE
    masks label -1);
  * the per-branch batch-hard triplet on pseudo-labels is unchanged.
"""

from __future__ import annotations

import numpy as np


def one_shot_subset(train_items, seed: int = 0):
    """One labeled image per identity (deterministic): the SSG++ input."""
    rng = np.random.default_rng(seed)
    by_pid: dict[int, list[int]] = {}
    for i, (_, pid, _) in enumerate(train_items):
        by_pid.setdefault(pid, []).append(i)
    chosen = {int(rng.choice(v)): pid for pid, v in sorted(by_pid.items())}
    return chosen  # {dataset_index: true_pid}


def affiliate_clusters(
    labels: np.ndarray, one_shot: dict[int, int]
) -> np.ndarray:
    """Propagate one-shot identities through clusters.

    Args:
      labels: (N,) DBSCAN labels (whole-body group), -1 noise.
      one_shot: {index: true_pid} for the labeled subset.

    Returns:
      (N,) int32 identity labels; -1 where unknown. A cluster inherits a
      pid iff all its one-shot members agree on that pid.
    """
    n = labels.shape[0]
    out = np.full((n,), -1, dtype=np.int32)
    cluster_pid: dict[int, int] = {}
    ambiguous: set[int] = set()
    for idx, pid in one_shot.items():
        c = int(labels[idx])
        if c < 0:
            continue
        if c in cluster_pid and cluster_pid[c] != pid:
            ambiguous.add(c)
        else:
            cluster_pid[c] = pid
    for c, pid in cluster_pid.items():
        if c in ambiguous:
            continue
        out[labels == c] = pid
    # One-shot images always keep their own label (even noise points).
    for idx, pid in one_shot.items():
        out[idx] = pid
    return out
