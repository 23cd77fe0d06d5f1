"""Identity metric: the reference's 'euclidean' DistanceMetric algorithm
([reid/metric_learning/euclidean.py], SURVEY.md §2 #14). ``fit`` is a no-op
and ``transform`` returns the features unchanged."""

from __future__ import annotations

import torch


class Euclidean:
    def fit(self, X, y=None, device=None):
        return self

    def transform(self, X):
        return torch.as_tensor(X)
