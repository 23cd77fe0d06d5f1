"""Loss surface (counterpart of ``ssg_tpu.loss``): ``TripletLoss``
(batch-hard) and ``OIMLoss`` (Online Instance Matching)."""

from ssg_tpu_torch.loss.oim import OIMLoss, oim_loss
from ssg_tpu_torch.loss.triplet import TripletLoss
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss

__all__ = ["OIMLoss", "TripletLoss", "batch_hard_triplet_loss", "oim_loss"]
