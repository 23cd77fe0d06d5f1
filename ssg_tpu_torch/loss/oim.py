"""Online Instance Matching (OIM) loss.

Counterpart of ``ssg_tpu/loss/oim.py``, the open-reid family's OIM
([reid/loss/oim.py], SURVEY.md §2 #7): a lookup table (LUT) of one
L2-normalised prototype per identity; the logits are the cosine
similarities ``x @ lut.T / temperature``; after each step the matched
prototypes move towards the batch's features.

``oim_loss`` returns ``(loss, new_lut)`` and leaves ``lut`` as it is;
``OIMLoss`` holds the LUT and updates it in place. No gradient reaches the
LUT: the update is made from the detached features of the same forward.
The update is batch-order-invariant, as the JAX package's: each matched
class moves once, towards the mean of its batch features (two
``index_add_``), where the reference moves it once per sample in batch
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssg_tpu_torch._device import resolve_device


def oim_loss(lut: torch.Tensor, features: torch.Tensor, labels: torch.Tensor,
             temperature: float = 0.1, momentum: float = 0.5):
    """Returns ``(loss, new_lut)``, fp32.

    lut: (num_classes, F) L2-normalised prototypes; features: (B, F)
    L2-normalised; labels: (B,) int in [0, num_classes). Rows whose label is
    below 0 (unlabelled) are left out of the loss and of the update, and
    unmatched rows of the LUT come back bit for bit.
    """
    x = features.float()
    table = lut.float()
    logits = x @ table.T / temperature
    valid = labels >= 0
    safe = labels.clamp_min(0)
    nll = F.cross_entropy(logits, safe, reduction="none")
    loss = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)

    with torch.no_grad():
        xs = torch.where(valid[:, None], x.detach(), 0.0)
        counts = torch.zeros(table.shape[0], dtype=torch.float32, device=table.device)
        counts.index_add_(0, safe, valid.float())
        sums = torch.zeros_like(table).index_add_(0, safe, xs)
        matched = (counts > 0)[:, None]
        mean_feat = sums / counts.clamp_min(1.0)[:, None]
        upd = torch.where(matched, momentum * table + (1.0 - momentum) * mean_feat, table)
        norm = upd.norm(dim=1, keepdim=True).clamp_min(1e-12)
        new_lut = torch.where(matched, upd / norm, upd)
    return loss, new_lut


class OIMLoss:
    """Stateful wrapper: holds the LUT (zeros at first, on ``device``: the
    card unless ``"cpu"``) and updates it in place at each call."""

    def __init__(self, num_features: int, num_classes: int, temperature: float = 0.1,
                 momentum: float = 0.5, device=None):
        self.temperature = float(temperature)
        self.momentum = float(momentum)
        self.lut = torch.zeros((num_classes, num_features), dtype=torch.float32,
                               device=resolve_device(device))

    def __call__(self, features: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        loss, new_lut = oim_loss(self.lut, features, labels, self.temperature, self.momentum)
        self.lut.copy_(new_lut)
        return loss
