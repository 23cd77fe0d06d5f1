"""Fixed-size host batches of ``(images_u8, pids, cams, mask)``.

Counterpart of the host-rendering path of ``ssg_tpu/data/preprocessor.py``:
renders a whole batch to one uint8 (B, H, W, 3) numpy array, pads the tail
batch to the full batch size by repeating its last item, and marks real
rows in ``mask`` so consumers can drop the padding after extraction.
``gather`` renders an arbitrary index batch (the P x K training batches).
"""

from __future__ import annotations

import numpy as np


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
