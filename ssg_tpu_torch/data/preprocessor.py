"""Fixed-size host batches of ``(images_u8, pids, cams, mask)``.

Counterpart of the host-rendering path of ``ssg_tpu/data/preprocessor.py``:
renders a whole batch to one uint8 (B, H, W, 3) numpy array, pads the tail
batch to the full batch size by repeating its last item, and marks real
rows in ``mask`` so consumers can drop the padding after extraction.
``gather`` renders an arbitrary index batch (the P x K training batches).

An on-disk dataset (one with ``images_dir``) streams through the native
loader where it is available (``_native_stream``, the JAX package's): its
threads decode batch i+1 while batch i is on the card. The loader
zero-pads the tail batch; the stream repeats the last real image there
instead, so a batch is the same whichever decoder made it.
"""

from __future__ import annotations

import os

import numpy as np

from ssg_tpu_torch.data import native_loader
from ssg_tpu_torch.data.synthetic import RAW_H, RAW_W


class Preprocessor:
    """Iterable over fixed-size batches of (images_u8, pids, camids, mask)."""

    def __init__(self, dataset, items=None, batch_size: int = 64):
        self.dataset = dataset
        self.items = list(items if items is not None else dataset.train)
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    @property
    def fnames(self) -> list[str]:
        return [f for f, _, _ in self.items]

    def gather(self, indices):
        """Render an arbitrary index batch: (images_u8, pids, cams)."""
        chosen = [self.items[int(i)] for i in indices]
        pids = np.asarray([p for _, p, _ in chosen], dtype=np.int32)
        cams = np.asarray([c for _, _, c in chosen], dtype=np.int32)
        return self.dataset.render([f for f, _, _ in chosen]), pids, cams

    def __iter__(self):
        stream = self._native_stream()
        if stream is not None:
            yield from stream
            return
        bs = self.batch_size
        for start in range(0, len(self.items), bs):
            chunk = self.items[start:start + bs]
            n = len(chunk)
            chunk = chunk + [chunk[-1]] * (bs - n)
            images = self.dataset.render([f for f, _, _ in chunk])
            pids = np.asarray([p for _, p, _ in chunk], dtype=np.int32)
            cams = np.asarray([c for _, _, c in chunk], dtype=np.int32)
            mask = np.zeros((bs,), dtype=bool)
            mask[:n] = True
            yield images, pids, cams, mask

    def _native_stream(self):
        """Batches decoded ahead by the native loader's threads, for an
        on-disk dataset; None where there is none or no native loader."""
        images_dir = getattr(self.dataset, "images_dir", None)
        if images_dir is None or not native_loader.is_available():
            return None
        bs = self.batch_size
        loader = native_loader.BatchLoader(
            [os.path.join(images_dir, f) for f, _, _ in self.items], batch_size=bs,
            height=RAW_H, width=RAW_W)

        def gen():
            try:
                for start, (images, valid) in zip(range(0, len(self.items), bs), loader):
                    images[valid:] = images[valid - 1]
                    chunk = self.items[start:start + bs]
                    chunk = chunk + [chunk[-1]] * (bs - len(chunk))
                    pids = np.asarray([p for _, p, _ in chunk], dtype=np.int32)
                    cams = np.asarray([c for _, _, c in chunk], dtype=np.int32)
                    mask = np.zeros((bs,), dtype=bool)
                    mask[:valid] = True
                    yield images, pids, cams, mask
            finally:
                loader.close()

        return gen()
