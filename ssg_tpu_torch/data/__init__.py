"""Data: synthetic datasets, host batching and test-time transforms (counterparts of ``ssg_tpu.data``)."""

from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.data.preprocessor import Preprocessor

__all__ = ["datasets", "Preprocessor"]
