"""Filesystem helpers, mirroring the reference's [reid/utils/osutils.py]
(SURVEY.md §2 #13) as ``ssg_tpu/utils/osutils.py`` does.
``mkdir_if_missing`` lives in serialization; re-exported here so the
reference's import path maps one to one."""

from ssg_tpu_torch.utils.serialization import mkdir_if_missing

__all__ = ["mkdir_if_missing"]
