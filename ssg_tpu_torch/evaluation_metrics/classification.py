"""Top-k classification accuracy.

Counterpart of ``ssg_tpu/evaluation_metrics/classification.py``, which
mirrors the reference's [reid/evaluation_metrics/classification.py]
``accuracy(output, target, topk)`` (SURVEY.md §2 #8). ``lax.top_k`` puts
the lower index first among tied logits; ``torch.topk`` promises no order,
so the ranks come from a stable descending sort, which keeps that order.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch._device import resolve_device


def accuracy(output, target, topk: tuple = (1,), device=None) -> list[float]:
    """Fraction of rows whose target is within the top-k logits, per k.
    ``output`` (B, C) and ``target`` (B,) are tensors or numpy arrays,
    moved to ``device`` (the card unless ``"cpu"``, ``_device.py``)."""
    dev = resolve_device(device)
    output = torch.as_tensor(output, device=dev)
    target = torch.as_tensor(target, device=dev)
    maxk = max(topk)
    pred = torch.sort(output, dim=1, descending=True, stable=True).indices[:, :maxk]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(1).float().mean()) for k in topk]
