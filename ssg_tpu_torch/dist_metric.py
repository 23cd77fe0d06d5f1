"""DistanceMetric, the open-reid metric shim.

Counterpart of ``ssg_tpu/dist_metric.py``, mirroring the reference's
[reid/dist_metric.py] (SURVEY.md §2 #14): wraps a metric-learning algorithm
('euclidean' or 'kissme'), fits it on features extracted from a labelled
stream, and transforms features before distances are taken. SSG itself
runs with 'euclidean' (plain L2 + re-ranking); 'kissme' is kept for the
surface.
"""

from __future__ import annotations

from ssg_tpu_torch.metric_learning import get_metric


class DistanceMetric:
    def __init__(self, algorithm: str = "euclidean", *args, **kwargs):
        self.algorithm = algorithm
        self.metric = get_metric(algorithm, *args, **kwargs)

    def train(self, model, preprocessor, device=None):
        """Extract features from a labelled ``Preprocessor`` stream and fit
        the metric on the whole-body branch (index 0), on ``device`` (the
        card unless ``"cpu"``). ``model`` must already be on that device."""
        if self.algorithm == "euclidean":
            return self
        from ssg_tpu_torch.api import extract_features

        feats, pids, _, _ = extract_features(model, preprocessor, device=device)
        self.metric.fit(feats[0], pids, device=device)
        return self

    def transform(self, X):
        return self.metric.transform(X)
