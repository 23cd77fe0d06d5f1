"""Loss surface (counterpart of ``ssg_tpu.loss``): ``TripletLoss``
(batch-hard). ``OIMLoss`` is not ported yet (ROADMAP A)."""

from ssg_tpu_torch.loss.triplet import TripletLoss
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss

__all__ = ["TripletLoss", "batch_hard_triplet_loss"]
