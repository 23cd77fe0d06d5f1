"""Utilities (counterparts of ``ssg_tpu.utils``): meters, logging,
checkpoints and json, profiling (``utils.profiling``) and trace reading
(``utils.traceview``). The XLA compile cache (``utils/cache.py``) has no
counterpart: the port runs eagerly, and its CUDA and native builds are kept
in ``ssg_tpu_torch/_build/``."""

from ssg_tpu_torch.utils.logging import Logger
from ssg_tpu_torch.utils.meters import AverageMeter
from ssg_tpu_torch.utils.serialization import (
    copy_state_dict,
    load_checkpoint,
    mkdir_if_missing,
    read_json,
    save_checkpoint,
    write_json,
)

__all__ = ["Logger", "AverageMeter", "copy_state_dict", "load_checkpoint", "mkdir_if_missing",
           "read_json", "save_checkpoint", "write_json"]
