"""Class-shaped wrapper over the batch-hard triplet loss.

Counterpart of ``ssg_tpu/loss/triplet.py``: the reference's
``TripletLoss(margin)`` call shape, ``__call__(embeddings, labels) ->
(loss, prec)``, on top of ``ssg_tpu_torch.ops.triplet``.
"""

from __future__ import annotations

from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss


class TripletLoss:
    def __init__(self, margin: float = 0.3):
        self.margin = float(margin)

    def __call__(self, embeddings, labels):
        return batch_hard_triplet_loss(embeddings, labels, margin=self.margin)
