"""h5py-backed feature store.

Counterpart of ``ssg_tpu/feature_extraction/database.py``, mirroring the
reference's ``FeatureDatabase`` ([reid/feature_extraction/database.py],
SURVEY.md §2 #9): a dict-like mapping fname -> feature vector persisted in
one HDF5 file, stored as float32. Gated on h5py, as the JAX package's is:
without it, constructing one raises.
"""

from __future__ import annotations

import numpy as np

try:
    import h5py

    _HAVE_H5PY = True
except ImportError:
    _HAVE_H5PY = False


class FeatureDatabase:
    def __init__(self, fpath: str, mode: str = "r"):
        if not _HAVE_H5PY:
            raise RuntimeError("h5py unavailable; FeatureDatabase is gated")
        self._f = h5py.File(fpath, mode)

    def __setitem__(self, key: str, value) -> None:
        if hasattr(value, "detach"):  # a tensor, possibly on the card
            value = value.detach().cpu()
        arr = np.asarray(value, dtype=np.float32)
        if key in self._f:
            del self._f[key]
        self._f.create_dataset(key, data=arr)

    def __getitem__(self, key: str) -> np.ndarray:
        return np.asarray(self._f[key])

    def __contains__(self, key: str) -> bool:
        return key in self._f

    def __len__(self) -> int:
        return len(self._f)

    def keys(self):
        return list(self._f.keys())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
