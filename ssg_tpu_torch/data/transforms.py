"""Batch image transforms, NHWC in and NHWC out, on the images' device.

Counterpart of ``ssg_tpu/data/transforms.py``:

* test time: ``rect_scale`` (the reference's RectScale, bilinear resize)
  and ImageNet ``normalize``. ``rect_scale`` matches
  ``jax.image.resize(method="bilinear")``: half-pixel centres, and a
  triangle filter widened by the scale factor when shrinking
  (``antialias=True``), which is what JAX does by default.
* train time: the reference's RandomSizedRectCrop and horizontal flip.
  ``draw_crops`` draws each image's box (area 0.64-1 of H x W, aspect h/w
  2-3, clipped to the image, placed at U(0, 1) of the slack) and flip on
  the generator's device, with no host sync. ``crop_flip`` resamples each
  box to the output size as ``jax.image.scale_and_translate(method=
  "bilinear")`` does: separable weight matrices per image, built as its
  ``compute_weight_mat`` builds them, applied as two batched fp32 products
  (TF32 off, ``_device.py``). ``F.interpolate`` cannot crop a fractional
  box. The random streams differ from JAX's; the boxes' distribution and
  the resampling of a given box are what match. ``train_transform``,
  ``random_sized_rect_crop`` and ``random_horizontal_flip`` are the JAX
  package's names over the two, taking a ``torch.Generator`` where JAX
  takes a key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_STATS: dict = {}  # device -> (mean, std), built once a device by _stats


def _stats(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as fp32 tensors on ``device``, built on a
    device's first call and the same tensors on every later one: building
    them copies from pageable host memory, which waits for the device and
    which a CUDA graph cannot capture. Callers only read them."""
    device = torch.device(device)
    stats = _STATS.get(device)
    if stats is None:
        stats = _STATS[device] = (
            torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))
    return stats


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


def normalize_float(x: torch.Tensor, dtype, stats=None) -> torch.Tensor:
    """Float pixels on the 0..255 scale -> ImageNet-normalised ``dtype``.
    ``stats``: the ``(mean, std)`` of ``_stats(x.device)``, which it takes
    when none are given."""
    mean, std = _stats(x.device) if stats is None else stats
    return ((x / 255.0 - mean) / std).to(dtype)


def test_transform(images_u8: torch.Tensor, height: int = 256, width: int = 128,
                   dtype=torch.float32) -> torch.Tensor:
    """Test-time pipeline: resize (if needed) -> normalise."""
    x = images_u8
    if x.shape[1] != height or x.shape[2] != width:
        x = rect_scale(x, height, width)
    if x.dtype == torch.uint8:
        return normalize(x, dtype=dtype)
    return normalize_float(x, dtype)


def draw_crops(generator: torch.Generator, batch: int, height: int,
               width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """RandomSizedRectCrop boxes and flips for ``batch`` images of
    ``height`` x ``width``, drawn on ``generator``'s device.

    Returns ``boxes`` (batch, 4) fp32 as ``(y0, x0, crop_h, crop_w)`` in
    pixels and ``flips`` (batch,) bool, as ``ssg_tpu.data.transforms``
    draws them: area U(0.64, 1) x H W, aspect h/w U(2, 3), each side
    clipped to [1, image side], the corner at U(0, 1) of the slack, a flip
    with probability 0.5.
    """
    u = torch.rand((5, batch), generator=generator, device=generator.device)
    area = (0.64 + 0.36 * u[0]) * float(height * width)
    aspect = 2.0 + u[1]
    crop_h = torch.sqrt(area * aspect).clamp(1.0, float(height))
    crop_w = torch.sqrt(area / aspect).clamp(1.0, float(width))
    y0 = u[2] * (height - crop_h)
    x0 = u[3] * (width - crop_w)
    return torch.stack([y0, x0, crop_h, crop_w], 1), u[4] < 0.5


def _resample_weights(in_size: int, out_size: int, start: torch.Tensor,
                      size: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) bilinear weights that resample [start, start +
    size) of each image's axis to ``out_size`` samples: JAX's
    ``compute_weight_mat`` with the triangle kernel, antialiased, at scale
    ``out_size / size`` and translation ``-start * out_size / size``."""
    dev = start.device
    scale = out_size / size
    translation = -start * out_size / size
    inv_scale = 1.0 / scale
    kernel_scale = inv_scale.clamp_min(1.0)  # widened only when shrinking
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = ((out_idx[None, :] + 0.5) * inv_scale[:, None]
              - (translation * inv_scale)[:, None] - 0.5)  # (B, out)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)
    dist = (sample[:, None, :] - in_idx[None, :, None]).abs() / kernel_scale[:, None, None]
    w = (1.0 - dist).clamp_min(0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, 0.0)


def crop_flip(images: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor,
              height: int, width: int) -> torch.Tensor:
    """Resample each image's box to (height, width), then mirror the images
    whose ``flips`` is set. (B, H, W, C) uint8 or float -> (B, height,
    width, C) fp32 on the 0..255 scale."""
    b, h, w, c = images.shape
    x = images.float()
    wy = _resample_weights(h, height, boxes[:, 0], boxes[:, 2])  # (B, H, height)
    wx = _resample_weights(w, width, boxes[:, 1], boxes[:, 3])  # (B, W, width)
    wx = torch.where(flips[:, None, None], wx.flip(2), wx)  # a flip reverses the output columns
    rows = torch.bmm(wy.transpose(1, 2), x.reshape(b, h, w * c))  # (B, height, W C)
    rows = rows.reshape(b, height, w, c).transpose(2, 3).reshape(b, height * c, w)
    out = torch.bmm(rows, wx)  # (B, height C, width)
    return out.reshape(b, height, c, width).transpose(2, 3)


def random_sized_rect_crop(generator: torch.Generator, images: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """Batched RandomSizedRectCrop: each image's ``draw_crops`` box
    resampled to (height, width), fp32 on the 0..255 scale."""
    b, h, w, _ = images.shape
    boxes, _ = draw_crops(generator, b, h, w)
    return crop_flip(images, boxes, torch.zeros_like(boxes[:, 0], dtype=torch.bool), height,
                     width)


def random_horizontal_flip(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Mirror each (B, H, W, C) image with probability 0.5: the flips of
    ``draw_crops``."""
    _, flips = draw_crops(generator, *images.shape[:3])
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def train_transform(generator: torch.Generator, images_u8: torch.Tensor, height: int = 256,
                    width: int = 128, dtype=torch.float32) -> torch.Tensor:
    """Train-time pipeline: random crop -> flip -> normalise, the boxes and
    flips drawn by one ``draw_crops``, as the train step draws them."""
    boxes, flips = draw_crops(generator, *images_u8.shape[:3])
    return normalize_float(crop_flip(images_u8, boxes, flips, height, width), dtype)
