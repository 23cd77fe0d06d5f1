"""Batch image transforms, NHWC in and NHWC out.

Counterpart of the test-time half of ``ssg_tpu/data/transforms.py``:
``rect_scale`` (the reference's RectScale, bilinear resize) and ImageNet
``normalize``. ``rect_scale`` matches ``jax.image.resize(method="bilinear")``:
half-pixel centres, and a triangle filter widened by the scale factor when
shrinking (``antialias=True``), which is what JAX does by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(device):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    return mean, std


def normalize(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> ImageNet-normalised float (B, H, W, 3)."""
    mean, std = _stats(images_u8.device)
    x = images_u8.float() / 255.0
    return ((x - mean) / std).to(dtype)


def rect_scale(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of float (B, H, W, C) to (B, height, width, C)."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def test_transform(images_u8: torch.Tensor, height: int = 256, width: int = 128,
                   dtype=torch.float32) -> torch.Tensor:
    """Test-time pipeline: resize (if needed) -> normalise."""
    x = images_u8
    if x.shape[1] != height or x.shape[2] != width:
        x = rect_scale(x, height, width)
    if x.dtype == torch.uint8:
        return normalize(x, dtype=dtype)
    mean, std = _stats(x.device)
    return ((x / 255.0 - mean) / std).to(dtype)
