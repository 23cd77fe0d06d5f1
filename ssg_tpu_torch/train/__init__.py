"""Fine-tuning and the SSG loop (counterparts of ``ssg_tpu.train``)."""

from ssg_tpu_torch.train.trainer import Trainer, make_train_step

__all__ = ["Trainer", "make_train_step"]
