"""On-device synthetic image rendering.

Counterpart of ``ssg_tpu/data/synthetic_device.py``: the image model of
``SyntheticReID.render`` (``data/synthetic.py``) — a per-identity
low-frequency palette, a camera tint, a geometric jitter and pixel noise —
computed on the device. The palette ((ids, 8, 4, 3) fp32) and the camera
tints live there; only pids, cams and the items' seeds cross from the host.

The render splits in two:

* ``render(palette, cam_tint, pids, cams, dy, dx, noise)``, the
  deterministic core, in the JAX package's order: bilinear upsampling of
  each identity's palette to 256x128 (``F.interpolate``, half-pixel
  centres, as ``jax.image.resize``), a roll of each image by ``(dy, dx)``
  (one gather with per-row index arithmetic), ``+ noise``, ``+ tint``, then
  ``clip(x * 255, 0, 255)`` cast to uint8 by truncation. Fed the JAX
  renderer's own draws it reproduces its images to within one level;
* ``draw(seeds, device)``, the draws: ``dy`` in [-12, 12], ``dx`` in
  [-6, 6] and ``0.03 * N(0, 1)`` noise of shape (256, 128, 3), from one
  ``torch.Generator`` an item on ``device``, seeded with the item's
  ``_seed_for(fname, dataset.seed)``. An item's pixels depend on the item
  alone: not on its position in a batch nor on the batch size, and a
  padding row repeats its item's image.

Not bit-identical to the numpy renderer, nor to the JAX package's device
renderer: the three draw from different random streams (numpy's PCG64,
JAX's threefry, and here PyTorch's generator of the device: Philox on the
card, the Mersenne twister on the CPU). The distribution is the same,
identity-dominated and deterministic from the dataset seed, which is what
extraction and clustering benchmarks need.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.data.synthetic import RAW_H, RAW_W, SyntheticReID, _seed_for


def render(palette: torch.Tensor, cam_tint: torch.Tensor, pids: torch.Tensor,
           cams: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """(B,) metadata and draws -> (B, H, W, 3) uint8, H x W being
    ``noise``'s (B, H, W, 3), on the tensors' device."""
    b, h, w, _ = noise.shape
    base = F.interpolate(palette[pids].permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    # jnp.roll by (dy, dx): out[i, j] = base[(i - dy) mod H, (j - dx) mod W].
    rows = (torch.arange(h, device=dy.device)[None, :] - dy[:, None]) % h
    cols = (torch.arange(w, device=dx.device)[None, :] - dx[:, None]) % w
    img = base[torch.arange(b, device=pids.device)[:, None, None], rows[:, :, None],
               cols[:, None, :]]
    img = img + noise
    img = img + cam_tint[cams][:, None, None, :]
    return (img * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def draw(seeds, device, height: int = RAW_H,
         width: int = RAW_W) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy (B,), dx (B,), noise (B, height, width, 3) fp32) on ``device``,
    item b's from a generator seeded with ``seeds[b]``: dy, then dx, then
    the noise."""
    b = len(seeds)
    dy = torch.empty((b,), dtype=torch.int64, device=device)
    dx = torch.empty((b,), dtype=torch.int64, device=device)
    noise = torch.empty((b, height, width, 3), dtype=torch.float32, device=device)
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        dy[i:i + 1].random_(-12, 13, generator=gen)
        dx[i:i + 1].random_(-6, 7, generator=gen)
        noise[i].normal_(0.0, 1.0, generator=gen)
    return dy, dx, noise.mul_(0.03)


class DeviceRenderer:
    """Renders a ``SyntheticReID``'s items on the device in fixed-size
    batches."""

    def __init__(self, dataset: SyntheticReID, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.palette = torch.as_tensor(dataset._palette, device=self.device)
        self.cam_tint = torch.as_tensor(dataset._cam_tint, device=self.device)

    def batches(self, items, batch_size: int):
        """Yields ``(images_u8 on the device, pids, cams, mask)``, the
        ``Preprocessor`` contract that ``api.extract_features`` takes: a tail
        batch is padded by repeating its last item, and ``mask`` marks the
        real rows."""
        items = list(items)
        for start in range(0, len(items), batch_size):
            chunk = items[start:start + batch_size]
            n = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch_size - n)
            pids = np.asarray([p for _, p, _ in chunk], dtype=np.int32)
            cams = np.asarray([c for _, _, c in chunk], dtype=np.int32)
            dy, dx, noise = draw([_seed_for(f, self.dataset.seed) for f, _, _ in chunk],
                                 self.device)
            images = render(self.palette, self.cam_tint,
                            torch.as_tensor(pids, dtype=torch.int64, device=self.device),
                            torch.as_tensor(cams, dtype=torch.int64, device=self.device),
                            dy, dx, noise)
            mask = np.zeros((batch_size,), dtype=bool)
            mask[:n] = True
            yield images, pids, cams, mask
