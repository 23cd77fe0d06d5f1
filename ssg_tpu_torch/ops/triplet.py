"""Batch-hard triplet loss.

Counterpart of ``ssg_tpu/ops/triplet.py``, which mirrors the reference's
``TripletLoss`` ([reid/loss/triplet.py], SURVEY.md §2 #7): per anchor, the
hardest positive (max distance, same pseudo-id) and hardest negative (min
distance, different pseudo-id) within the P x K batch, fed to a margin
ranking loss. Masked reductions over the batch distance matrix, so it
stays on the device and is differentiable end to end:

* the Gram matrix is an fp32 product in true fp32 (TF32 off, ``_device.py``),
  as JAX's ``Precision.HIGHEST``;
* the square root is clamped at ``eps`` = 1e-12, as the reference;
* ``amax`` / ``amin`` split the gradient evenly between tied extremes, as
  JAX's ``max`` / ``min`` do (``torch.max(dim)`` would send it to one).
"""

from __future__ import annotations

import torch


def batch_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.3,
                            eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, prec), 0-dim fp32 tensors (fp64 for fp64 embeddings);
    prec is the fraction of anchors with d_an > d_ap, the reference's
    printed triplet accuracy.

    Rows with label < 0 (per-branch noise in the SSG multi-group scheme:
    an image may be clustered for the whole body but noise for a part) are
    masked out: they are neither anchors nor positives/negatives, and the
    mean runs over anchors that have both a non-self positive and a
    negative.
    """
    x = embeddings.to(torch.promote_types(embeddings.dtype, torch.float32))
    sq = (x * x).sum(1, keepdim=True)
    d = torch.sqrt((sq + sq.T - 2.0 * (x @ x.T)).clamp_min(eps))

    valid = labels >= 0
    pair_valid = valid[:, None] & valid[None, :]
    same = labels[:, None] == labels[None, :]
    pos = same & pair_valid
    neg = ~same & pair_valid
    big = 1e9
    d_ap = torch.where(pos, d, -big).amax(1)
    d_an = torch.where(neg, d, big).amin(1)

    not_self = ~torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    anchor = valid & (pos & not_self).any(1) & neg.any(1)
    n_anchor = anchor.sum().clamp_min(1)

    # MarginRankingLoss(margin) with y=1 on (d_an, d_ap), over live anchors.
    per = (d_ap - d_an + margin).clamp_min(0.0)
    loss = torch.where(anchor, per, 0.0).sum() / n_anchor
    prec = torch.where(anchor, (d_an > d_ap).float(), 0.0).sum() / n_anchor
    return loss, prec
