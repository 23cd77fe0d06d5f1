"""AverageMeter: the port's own copy of ``ssg_tpu/utils/meters.py``,
mirroring [reid/utils/meters.py] (SURVEY.md §2 #13)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
