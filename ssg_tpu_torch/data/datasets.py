"""Dataset factory: synthetic stand-ins shaped like the re-ID benchmarks.

Counterpart of the synthetic branch of ``ssg_tpu/data/datasets.py``: the
same names, sizes and scales, so the same ``(name, scale, seed)`` gives the
same splits and the same pixels in both packages. Real on-disk datasets
(``DirectoryReID``, the native loader) come in a later slice.
"""

from __future__ import annotations

from ssg_tpu_torch.data.synthetic import SyntheticReID

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


def names() -> list[str]:
    return sorted(_BENCHMARKS)


def create(name: str, scale: str | float = "small", seed: int = 0, **kw) -> SyntheticReID:
    """A deterministic synthetic dataset shaped like the named benchmark,
    with identity counts scaled by ``scale`` (a name in _SCALES or a float)."""
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
