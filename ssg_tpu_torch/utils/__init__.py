"""Utilities (counterparts of ``ssg_tpu.utils``): meters, logging and
checkpoints. The XLA compile cache (``utils/cache.py``) has no
counterpart; profiling comes in a later slice (ROADMAP A)."""

from ssg_tpu_torch.utils.logging import Logger
from ssg_tpu_torch.utils.meters import AverageMeter
from ssg_tpu_torch.utils.serialization import (
    copy_state_dict,
    load_checkpoint,
    mkdir_if_missing,
    save_checkpoint,
)

__all__ = ["Logger", "AverageMeter", "copy_state_dict", "load_checkpoint", "mkdir_if_missing",
           "save_checkpoint"]
