"""Dataset factory, mirroring the reference's ``datasets.create`` surface.

Counterpart of ``ssg_tpu/data/datasets.py``. Each dataset exposes
``.train / .query / .gallery`` as ``(fname, pid, camid)`` triplets plus
``num_train_ids``, and ``render(fnames)`` returns their uint8
(N, 256, 128, 3) images. Two backends:

* ``DirectoryReID``: real data on disk in the open-reid layout
  (``<root>/images/{pid:08d}_{camid:02d}_*.jpg`` plus ``splits.json``, as
  ``data.prepare`` writes it), decoded by the native loader
  (``data.native_loader``) or, where that library cannot be built, by PIL.
* ``SyntheticReID``: the deterministic synthetic stand-ins, with the same
  names, sizes and scales as the JAX package's, so the same
  ``(name, scale, seed)`` gives the same splits and pixels in both.

``create(name, root)`` picks ``DirectoryReID`` when ``root/images`` exists,
otherwise a synthetic dataset shaped like the named benchmark.
"""

from __future__ import annotations

import os

import numpy as np

from ssg_tpu_torch.data import native_loader
from ssg_tpu_torch.data.synthetic import RAW_H, RAW_W, SyntheticReID
from ssg_tpu_torch.utils.serialization import read_json

# (train_ids, test_ids, cams) of the real benchmarks.
_BENCHMARKS = {
    "market1501": dict(train_ids=751, test_ids=750, cams=6),
    "dukemtmc": dict(train_ids=702, test_ids=702, cams=8),
    "msmt17": dict(train_ids=1041, test_ids=3060, cams=15),
    "cuhk03": dict(train_ids=1367, test_ids=100, cams=2),
}

_SCALES = {
    "tiny": 0.02,  # unit tests
    "small": 0.1,  # integration tests
    "full": 1.0,
}


class DirectoryReID:
    """Open-reid directory layout: images named {pid:08d}_{camid:02d}_*.jpg."""

    def __init__(self, name: str, root: str, split_id: int = 0):
        self.name = name
        self.root = root
        self.images_dir = os.path.join(root, "images")
        splits_path = os.path.join(root, "splits.json")
        if os.path.exists(splits_path):
            splits = read_json(splits_path)
            if not 0 <= split_id < len(splits):
                raise ValueError(
                    f"split_id {split_id} out of range ({len(splits)} splits)"
                )
            split = splits[split_id]
            self.train = [tuple(x) for x in split["train"]]
            self.query = [tuple(x) for x in split["query"]]
            self.gallery = [tuple(x) for x in split["gallery"]]
        else:
            # Single-split fallback: everything is train.
            items = []
            for fname in sorted(os.listdir(self.images_dir)):
                if not fname.endswith((".jpg", ".png")):
                    continue
                items.append((fname, int(fname[:8]), int(fname[9:11])))
            self.train, self.query, self.gallery = items, [], []
        self.num_train_ids = len({pid for _, pid, _ in self.train})

    def render(self, fnames: list[str]) -> np.ndarray:
        """The named images, decoded and resized to (N, RAW_H, RAW_W, 3) u8:
        by the native loader's threads, or by PIL where it is unavailable."""
        paths = [os.path.join(self.images_dir, f) for f in fnames]
        if native_loader.is_available():
            return native_loader.load_batch(paths, RAW_H, RAW_W)
        from PIL import Image

        out = np.empty((len(fnames), RAW_H, RAW_W, 3), dtype=np.uint8)
        for b, path in enumerate(paths):
            with Image.open(path) as img:
                out[b] = np.asarray(img.convert("RGB").resize((RAW_W, RAW_H), Image.BILINEAR),
                                    dtype=np.uint8)
        return out


def names() -> list[str]:
    return sorted(_BENCHMARKS)


def create(name: str, root: str | None = None, scale: str | float = "small", seed: int = 0,
           split_id: int = 0, **kw):
    """The dataset at ``root`` when ``root/images`` exists (``split_id``
    selects among ``splits.json``'s entries), else a deterministic synthetic
    dataset shaped like the named benchmark, with identity counts scaled by
    ``scale`` (a name in _SCALES or a float)."""
    if root is not None and os.path.isdir(os.path.join(root, "images")):
        return DirectoryReID(name, root, split_id=split_id)
    if name not in _BENCHMARKS:
        raise KeyError(f"Unknown dataset: {name!r}; known: {names()}")
    bench = _BENCHMARKS[name]
    frac = _SCALES.get(scale, None)
    if frac is None:
        frac = float(scale)
    return SyntheticReID(
        name=name,
        num_train_ids=max(8, int(bench["train_ids"] * frac)),
        num_test_ids=max(8, int(bench["test_ids"] * frac)),
        cams=bench["cams"],
        seed=seed,
        **kw,
    )
