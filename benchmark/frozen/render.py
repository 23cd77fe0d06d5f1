"""Synthetic re-id images rendered on the device.

The image model and its arithmetic are copied from
``ssg_tpu_torch/data/synthetic_device.py`` (``render``) and
``ssg_tpu_torch/data/synthetic.py`` (the palette and camera tints) at
commit 78531ab: a per-identity (8, 4, 3) palette in U(0.1, 0.9) upsampled
bilinearly (half-pixel centres) to H x W, rolled by (dy, dx) with dy in
[-12, 12] and dx in [-6, 6], plus 0.03 N(0, 1) pixel noise and a camera
tint in U(-0.12, 0.12), then ``clip(x * 255, 0, 255)`` truncated to uint8.
The draws here come in bulk from one generator on the device, a chunk of
images a call, not from one generator an item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def render(palette: torch.Tensor, cam_tint: torch.Tensor, pids: torch.Tensor,
           cams: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """(B,) metadata and draws -> (B, H, W, 3) uint8, H x W being
    ``noise``'s (B, H, W, 3)."""
    b, h, w, _ = noise.shape
    base = F.interpolate(palette[pids].permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    rows = (torch.arange(h, device=dy.device)[None, :] - dy[:, None]) % h
    cols = (torch.arange(w, device=dx.device)[None, :] - dx[:, None]) % w
    img = base[torch.arange(b, device=pids.device)[:, None, None], rows[:, :, None],
               cols[:, None, :]]
    img = img + noise
    img = img + cam_tint[cams][:, None, None, :]
    return (img * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def render_pool(gen: torch.Generator, pids: torch.Tensor, num_ids: int, cams: int,
                height: int, width: int, chunk: int = 1024, out: torch.Tensor | None = None):
    """Every image of ``pids`` (N,) on ``gen``'s device: (N, height, width,
    3) uint8, written into ``out`` (a tensor on any device) where given.
    Cameras are drawn uniformly; returns ``(images, cams)``."""
    dev = gen.device
    palette = torch.empty((num_ids, 8, 4, 3), device=dev).uniform_(0.1, 0.9, generator=gen)
    tint = torch.empty((cams, 3), device=dev).uniform_(-0.12, 0.12, generator=gen)
    n = pids.shape[0]
    cam = torch.randint(0, cams, (n,), generator=gen, device=dev)
    if out is None:
        out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dy = torch.randint(-12, 13, (e - s,), generator=gen, device=dev)
        dx = torch.randint(-6, 7, (e - s,), generator=gen, device=dev)
        noise = torch.randn((e - s, height, width, 3), generator=gen, device=dev).mul_(0.03)
        out[s:e].copy_(render(palette, tint, pids[s:e], cam[s:e], dy, dx, noise))
    return out, cam
