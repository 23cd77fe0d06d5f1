"""Metric learning, mirroring the reference's [reid/metric_learning/]
(SURVEY.md §2 #14): KISSME plus the identity ("euclidean") metric.
Counterpart of ``ssg_tpu/metric_learning``: the estimators are written
directly in PyTorch (two covariance products, two inverses and one
eigendecomposition, fp32 on the device)."""

from ssg_tpu_torch.metric_learning.euclidean import Euclidean
from ssg_tpu_torch.metric_learning.kissme import KISSME

__all__ = ["Euclidean", "KISSME", "get_metric"]

_METRICS = {"euclidean": Euclidean, "kissme": KISSME}


def get_metric(algorithm: str, *args, **kwargs):
    if algorithm not in _METRICS:
        raise KeyError(f"Unknown metric: {algorithm!r}; known: {sorted(_METRICS)}")
    return _METRICS[algorithm](*args, **kwargs)
