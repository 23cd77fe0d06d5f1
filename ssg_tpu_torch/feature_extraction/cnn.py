"""Single-batch CNN feature extraction.

Counterpart of ``ssg_tpu/feature_extraction/cnn.py``, mirroring the
reference's ``extract_cnn_feature(model, inputs)``
([reid/feature_extraction/cnn.py], SURVEY.md §2 #9): an eval-mode, no-grad
forward of one raw uint8 HWC batch through the test transform, returning
the multi-branch embeddings.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.api import _forward_eval


def extract_cnn_feature(model, inputs, device=None) -> torch.Tensor:
    """``inputs``: a (B, H, W, 3) uint8 batch (numpy or tensor) of raw
    images; the transform is applied here, so already transformed floats
    are refused (``TypeError``). ``model`` must already be on ``device``
    (the card unless ``"cpu"``); it runs in eval mode, which is restored
    afterwards. Returns (num_parts, B, F) L2-normalised embeddings on the
    device."""
    images = torch.as_tensor(inputs)
    if images.dtype != torch.uint8:
        raise TypeError("extract_cnn_feature expects raw uint8 HWC batches")
    dev = resolve_device(device)
    was_training = model.training
    model.eval()
    try:
        return _forward_eval(model, images.to(dev))
    finally:
        model.train(was_training)
