"""Deterministic synthetic person re-ID datasets (numpy renderer).

The port's own copy of ``ssg_tpu/data/synthetic.py``: the same seed gives
byte-identical uint8 images in both packages, so both see the same pixels.
Datasets have the structure of Market-1501 / DukeMTMC / MSMT17
(train/query/gallery splits of ``(fname, pid, camid)`` triplets, open-reid
file naming ``{pid:08d}_{camid:02d}_{idx:04d}.jpg``) with images whose
appearance is identity-dominated, so that re-ID clustering is learnable.

Image model: each identity gets a smooth low-frequency color pattern
(upsampled PRNG palette); each instance adds a camera color tint, geometric
jitter, and pixel noise. Fully deterministic from (name, seed).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

# Canonical raw image size (pre-augmentation). Real Market-1501 images are
# 128x64; we synthesize at the network input size to skip a resize.
RAW_H, RAW_W = 256, 128


def _seed_for(name: str, seed: int) -> int:
    h = hashlib.sha256(f"{name}:{seed}".encode()).digest()
    return int.from_bytes(h[:8], "little")


def _identity_palette(rng: np.random.Generator, num_ids: int) -> np.ndarray:
    """Low-res per-identity appearance codes: (num_ids, 8, 4, 3) in [0, 1]."""
    return rng.uniform(0.1, 0.9, size=(num_ids, 8, 4, 3)).astype(np.float32)


def _upsample(pattern: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest+linear-ish upsample of (ph, pw, 3) to (h, w, 3)."""
    ph, pw, _ = pattern.shape
    yi = np.linspace(0, ph - 1, h)
    xi = np.linspace(0, pw - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, ph - 1)
    x1 = np.minimum(x0 + 1, pw - 1)
    wy = (yi - y0)[:, None, None]
    wx = (xi - x0)[None, :, None]
    p00 = pattern[y0][:, x0]
    p01 = pattern[y0][:, x1]
    p10 = pattern[y1][:, x0]
    p11 = pattern[y1][:, x1]
    return (
        p00 * (1 - wy) * (1 - wx)
        + p01 * (1 - wy) * wx
        + p10 * wy * (1 - wx)
        + p11 * wy * wx
    )


@dataclass
class SyntheticReID:
    """A synthetic dataset with open-reid structure.

    Attributes mirror the reference dataset objects (SURVEY.md §1 table):
    ``.train / .query / .gallery`` are lists of ``(fname, pid, camid)``;
    ``num_train_ids`` counts distinct train identities. ``render(fnames)``
    produces uint8 (B, RAW_H, RAW_W, 3) image batches.
    """

    name: str
    num_train_ids: int = 64
    num_test_ids: int = 32
    cams: int = 6
    train_imgs_per_id: int = 8
    query_imgs_per_id: int = 2
    gallery_imgs_per_id: int = 4
    seed: int = 0

    train: list = field(default_factory=list, init=False)
    query: list = field(default_factory=list, init=False)
    gallery: list = field(default_factory=list, init=False)

    def __post_init__(self):
        rng = np.random.default_rng(_seed_for(self.name, self.seed))
        total_ids = self.num_train_ids + self.num_test_ids
        self._palette = _identity_palette(rng, total_ids)
        self._cam_tint = rng.uniform(-0.12, 0.12, size=(self.cams, 3)).astype(
            np.float32
        )
        self._meta: dict[str, tuple[int, int, int]] = {}

        def add(split: list, pid: int, count: int, tag: int):
            for idx in range(count):
                cam = int((pid * 7 + idx * 3 + tag) % self.cams)
                fname = f"{pid:08d}_{cam:02d}_{tag:01d}{idx:04d}.jpg"
                split.append((fname, pid, cam))
                inst_seed = _seed_for(fname, self.seed)
                self._meta[fname] = (pid, cam, inst_seed)

        for pid in range(self.num_train_ids):
            add(self.train, pid, self.train_imgs_per_id, 0)
        for pid in range(self.num_train_ids, total_ids):
            add(self.query, pid, self.query_imgs_per_id, 1)
            add(self.gallery, pid, self.gallery_imgs_per_id, 2)

    @property
    def num_query_ids(self) -> int:
        return self.num_test_ids

    def render(self, fnames: list[str]) -> np.ndarray:
        """Render a batch of images as uint8 (B, RAW_H, RAW_W, 3)."""
        out = np.empty((len(fnames), RAW_H, RAW_W, 3), dtype=np.uint8)
        for b, fname in enumerate(fnames):
            pid, cam, inst_seed = self._meta[fname]
            rng = np.random.default_rng(inst_seed)
            base = _upsample(self._palette[pid], RAW_H, RAW_W)
            # Geometric jitter: roll by a few pixels (pose variation).
            dy, dx = rng.integers(-12, 13), rng.integers(-6, 7)
            img = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
            img = img + self._cam_tint[cam][None, None, :]
            img = img + rng.normal(0.0, 0.03, size=img.shape).astype(np.float32)
            out[b] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return out
