"""P x K identity-balanced batch sampling.

The port's own copy of ``ssg_tpu/data/sampler.py`` (numpy only), so the
same seed gives the same index batches in both packages. It mirrors the
reference's ``RandomIdentitySampler(data_source, num_instances)``
([reid/utils/data/sampler.py], SURVEY.md §2 #12): each batch holds P
identities x K instances, the layout batch-hard triplet mining requires.
Sampling runs on the host (cheap index math); batches are fixed-size.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class RandomIdentitySampler:
    """Yields epoch-long lists of dataset indices in P x K order.

    Args:
      data_source: list of (fname, pid, camid) triplets.
      num_instances: K — instances sampled per identity (with replacement
        when an identity has fewer than K images).
    """

    def __init__(self, data_source, num_instances: int = 4, seed: int = 0):
        self.data_source = data_source
        self.num_instances = num_instances
        self.index_dic: dict[int, list[int]] = defaultdict(list)
        for index, (_, pid, _) in enumerate(data_source):
            self.index_dic[pid].append(index)
        self.pids = sorted(self.index_dic.keys())
        self.num_samples = len(self.pids)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_samples * self.num_instances

    def epoch_indices(self, seed: int | None = None) -> np.ndarray:
        """One epoch of indices: identities shuffled, K instances each.

        With ``seed`` the epoch is drawn from a fresh generator keyed on it —
        reproducible independent of sampler history, so a resumed run
        replays the same epoch order (checkpoint/resume fidelity).
        """
        rng = self._rng if seed is None else np.random.default_rng(seed)
        order = rng.permutation(self.num_samples)
        out = []
        for i in order:
            candidates = self.index_dic[self.pids[i]]
            replace = len(candidates) < self.num_instances
            picks = rng.choice(
                candidates, size=self.num_instances, replace=replace
            )
            out.extend(int(p) for p in picks)
        return np.asarray(out, dtype=np.int64)

    def batches(self, batch_size: int, seed: int | None = None):
        """Yield fixed-size index batches (drops the ragged tail, as the JAX
        package does for its static shapes)."""
        idx = self.epoch_indices(seed)
        n_full = len(idx) // batch_size
        for b in range(n_full):
            yield idx[b * batch_size : (b + 1) * batch_size]
