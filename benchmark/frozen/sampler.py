"""The P x K draw of a fine-tuning epoch.

Copied from ``ssg_tpu_torch/data/sampler.py`` (``RandomIdentitySampler.
epoch_indices`` and ``batches``) at commit 78531ab: identities in a
permutation drawn from the epoch's seed, K instances of each (with
replacement only where an identity has fewer than K images), cut into
fixed-size batches with the ragged tail dropped.
"""

from __future__ import annotations

import numpy as np


def index_lists(pids: np.ndarray) -> list[np.ndarray]:
    """Indices of each identity's images, in identity order."""
    order = np.argsort(pids, kind="stable")
    _, starts = np.unique(pids[order], return_index=True)
    return np.split(order, starts[1:])


def epoch_batches(lists: list[np.ndarray], k: int, batch: int, seed: int) -> list[np.ndarray]:
    """One epoch of P x K index batches, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.permutation(len(lists)):
        candidates = lists[i]
        out.extend(int(p) for p in rng.choice(candidates, size=k,
                                              replace=len(candidates) < k))
    idx = np.asarray(out, dtype=np.int64)
    return [idx[b * batch:(b + 1) * batch] for b in range(len(idx) // batch)]
