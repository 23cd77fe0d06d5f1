"""What every cell shares: finding its files by name, seeds, the traced
slice, the isolation check and judging the readings against the limits."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "ssg_tpu")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(entries: list[dict], cell: str) -> list[dict]:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files, for one run."""

    root: Path
    bench_dir: Path
    name: str
    seed: int
    device: object = None
    bench: dict = field(default_factory=dict)
    workload: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    mix: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    kind: object = None

    @classmethod
    def load(cls, root: Path, name: str, seed: int, device=None) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(by_name)}")
        wl = by_name[name]
        conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
        here = root / bench["paths"][0]
        config = json.loads((root / conf["file"]).read_text())
        mix = json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text())
        limits = json.loads((here / "limits" / f"{name}.json").read_text())
        kind = load_module(here / "kinds" / f"{mix['kind']}.py", f"bench_kind_{mix['kind']}")
        return cls(root=root, bench_dir=here, name=name, seed=int(seed), device=device,
                   bench=bench, workload=wl, config=config, mix=mix, limits=limits, kind=kind)

    def sub(self, tag: str) -> int:
        return subseed(self.seed, tag)

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "bench_metric_" + name.replace(".", "_"))

    def end_to_end(self) -> list[dict]:
        return _for_cell(self.bench["end_to_end"], self.name)

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in _for_cell(self.bench["per_layer"], self.name) if m["moves"] in reported]


def profile_slice(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` with the device's activity only
    (tracing the host's operations would slow a host-bound step several
    times over), ending in a synchronise; its wall time on the host clock
    is the slice's window. Returns ``fn``'s counts under ``counts`` and the
    reduced trace. The trace goes to ``TMPDIR`` and is deleted once read."""
    import torch

    from benchmark.frozen import traceview

    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "slice.json")
        prof.export_chrome_trace(path)
        del prof
        reduced = traceview.reduce_slice(traceview.load(path), window_s)
    if reduced is None or reduced["busy_s"] <= 0:
        raise RuntimeError("the traced slice holds no device time")
    reduced["counts"] = counts
    return reduced


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Every reading at or under its limit (a missing or non-finite one fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
