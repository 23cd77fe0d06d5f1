"""KISSME metric learning (Koestinger et al., CVPR 2012).

Counterpart of ``ssg_tpu/metric_learning/kissme.py``. KISSME learns a
Mahalanobis matrix M = Sigma_similar^-1 - Sigma_dissimilar^-1 from the
covariances of pairwise differences; distances are (x-y)^T M (x-y). M is
projected to the PSD cone (eigenvalues clipped at 0), so M = L L^T and
``transform`` maps features through L, leaving downstream distances plain
Euclidean.

Pairs are drawn on the host by ``_pairs``, a copy of the JAX package's
with the same ``np.random.default_rng(seed)``, so both packages fit on the
same pairs. The covariance products, ``torch.linalg.inv`` and
``torch.linalg.eigh`` run in fp32 on the device (true fp32 on the card:
the port keeps TF32 off). ``L_`` is fixed only up to the sign of each
column (``eigh``'s eigenvectors); ``M_`` and the distances are not.
"""

from __future__ import annotations

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device


def _pairs(y: np.ndarray, rng: np.random.Generator, max_pairs: int):
    """Similar pairs: all within-class combinations (capped); dissimilar:
    an equal number of random cross-class pairs."""
    sim = []
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        if len(idx) < 2:
            continue
        a, b = np.meshgrid(idx, idx)
        m = a < b
        sim.append(np.stack([a[m], b[m]], 1))
    if not sim:
        raise ValueError("KISSME needs at least one class with >= 2 samples")
    sim = np.concatenate(sim, 0)
    if len(sim) > max_pairs:
        sim = sim[rng.choice(len(sim), max_pairs, replace=False)]
    n = len(sim)
    dis = np.empty((0, 2), np.int64)
    while len(dis) < n:
        cand = rng.integers(0, len(y), size=(2 * n, 2))
        cand = cand[y[cand[:, 0]] != y[cand[:, 1]]]
        dis = np.concatenate([dis, cand], 0)
    return sim, dis[:n]


class KISSME:
    def __init__(self, max_pairs: int = 50_000, eps: float = 1e-6, seed: int = 0):
        self.max_pairs = max_pairs
        self.eps = eps
        self.seed = seed
        self.M_ = None
        self.L_ = None

    def fit(self, X, y, device=None):
        """Fit on features ``X`` (N, D) with labels ``y`` (N,), on
        ``device`` (the card unless ``"cpu"``)."""
        X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
        y = np.asarray(y)
        sim, dis = _pairs(y, np.random.default_rng(self.seed), self.max_pairs)
        eye = torch.eye(X.shape[1], dtype=torch.float32, device=X.device)

        def diff_cov(pairs):
            idx = torch.as_tensor(pairs, device=X.device)
            d = X[idx[:, 0]] - X[idx[:, 1]]
            return d.T @ d / len(pairs) + self.eps * eye

        M = torch.linalg.inv(diff_cov(sim)) - torch.linalg.inv(diff_cov(dis))
        # Project to the PSD cone so M = L L^T exists and transform() is a
        # plain linear map (eigen-clip, standard KISSME post-processing).
        w, V = torch.linalg.eigh(M)
        w = w.clamp_min(0.0)
        self.M_ = (V * w) @ V.T
        self.L_ = V * w.sqrt()
        return self

    def transform(self, X):
        if self.L_ is None:
            raise RuntimeError("KISSME.fit must run before transform")
        return torch.as_tensor(X, dtype=torch.float32, device=self.L_.device) @ self.L_

    def distance(self, X, Y=None):
        """Squared Mahalanobis distances under the learned (PSD-projected) M."""
        a = self.transform(X)
        b = a if Y is None else self.transform(Y)
        sq = (a * a).sum(1, keepdim=True) + (b * b).sum(1, keepdim=True).T - 2.0 * (a @ b.T)
        return sq.clamp_min(0.0)
