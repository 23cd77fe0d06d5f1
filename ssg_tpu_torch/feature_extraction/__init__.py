"""Feature-extraction surface, mirroring the reference's
[reid/feature_extraction/__init__.py] (SURVEY.md §2 #9):
``extract_cnn_feature`` and the h5py-backed ``FeatureDatabase``
(counterpart of ``ssg_tpu/feature_extraction``)."""

from ssg_tpu_torch.feature_extraction.cnn import extract_cnn_feature
from ssg_tpu_torch.feature_extraction.database import FeatureDatabase

__all__ = ["extract_cnn_feature", "FeatureDatabase"]
