"""Evaluation metrics (counterpart of ``ssg_tpu.evaluation_metrics``), the
reference's [reid/evaluation_metrics/__init__.py] surface (SURVEY.md §2
#8): ``cmc``, ``mean_ap``, ``accuracy``."""

from ssg_tpu_torch.evaluation_metrics.classification import accuracy
from ssg_tpu_torch.evaluation_metrics.ranking import cmc, mean_ap

__all__ = ["accuracy", "cmc", "mean_ap"]
