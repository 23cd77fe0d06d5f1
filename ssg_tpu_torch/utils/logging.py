"""Stdout-tee logger: the port's own copy of ``ssg_tpu/utils/logging.py``,
mirroring the reference's ``Logger`` ([reid/utils/logging.py], SURVEY.md §2
#13) plus structured JSONL metrics (SURVEY.md §5 observability row)."""

from __future__ import annotations

import json
import os
import sys
import time


class Logger:
    """Tees stdout to ``fpath`` (the reference behavior) and optionally
    records structured metrics to ``fpath + '.jsonl'``."""

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        self.jsonl = None
        if fpath is not None:
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            self.file = open(fpath, "w")
            self.jsonl = open(fpath + ".jsonl", "w")

    def __del__(self):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def metric(self, **kv):
        if self.jsonl is not None:
            kv.setdefault("ts", time.time())
            self.jsonl.write(json.dumps(kv) + "\n")
            self.jsonl.flush()

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
