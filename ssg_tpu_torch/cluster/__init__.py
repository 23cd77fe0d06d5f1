"""Clustering: sklearn-identical DBSCAN and the SSG eps rule (counterparts of ``ssg_tpu.cluster``)."""

from ssg_tpu_torch.cluster.dbscan import dbscan
from ssg_tpu_torch.cluster.eps import select_eps

__all__ = ["dbscan", "select_eps"]
