"""A copy of the benchmark with tiny cells added from files alone, for the
CPU tests: a configuration, traffic mixes and limits written under a
temporary root beside a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# Train crops to the configuration's size; an extract always sees 256x128
# (the program's test transform resizes anything else).
TINY_CONFIG = {"name": "tiny", "stage_sizes": [1, 1, 1, 1], "last_stride": 2, "num_parts": 3,
               "num_features": 0, "height": 64, "width": 32, "dtype": "float32", "residual_bn_gamma": 0.1,
               "assumed": [], "reduced": ["stage_sizes", "height", "width", "dtype"]}
TINY_FULL = {**TINY_CONFIG, "name": "tiny-full", "height": 256, "width": 128}
MIXES = {
    "train-tiny": {"kind": "train", "images": 96, "identities": 12, "skew": 0.8, "cameras": 3,
                   "part_noise": [0.0, 0.1, 0.1], "batch": 8, "instances": 4, "margin": 0.3,
                   "lr": 6e-5, "weight_decay": 5e-4, "print_freq": 10, "prefetch_depth": 2,
                   "check_steps": 3, "warmup_steps": 1},
    "extract-tiny": {"kind": "extract", "images": 40, "identities": 6, "skew": 0.8,
                     "cameras": 3, "batch": 16},
    "cluster-tiny": {"kind": "cluster", "points": 300, "identities": 20, "skew": 0.8, "dim": 32,
                     "latent": 8, "groups": 2, "k1": 20, "k2": 6, "lambda_value": 0.1,
                     "rho": 1.6e-3, "min_samples": 4},
}
# Loose limits: the CPU tests judge the harness's flow and its faults, not
# the card's precision.
LIMITS = {"train": {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2, "emb_gap": 1e-3},
          "extract": {"emb_gap": 1e-3},
          "cluster": {"eps_gap": 1e-4, "label_gap": 1e-3}}


def make_root(tmp: Path, extra_metric: str | None = None) -> Path:
    """A checkout-like root under ``tmp``: the benchmark copied, and the
    tiny cells (``tiny-train``, ``tiny-extract``, ``tiny-cluster``) added
    as new files and entries. ``extra_metric``: the source of a further
    per-layer metric ``tiny_extra``, added the same way."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    for conf in (TINY_CONFIG, TINY_FULL):
        (here / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "a test's own", "reduced": [],
                                 "why": "a test", "file": f"benchmark/configs/{conf['name']}.json"})
    for mix, params in MIXES.items():
        (here / "traffic" / f"{mix}.json").write_text(json.dumps(params))
        cell = f"tiny-{params['kind']}"
        (here / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[params["kind"]]))
        conf = "tiny-full" if params["kind"] == "extract" else "tiny"
        bench["workloads"].append({"name": cell, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            kind = {"train_img_per_s": "train", "train_step_p95_ms": "train",
                    "cluster_s": "cluster", "extract_img_per_s": "extract"}[m["name"]]
            m["workloads"].append(f"tiny-{kind}")
    for m in bench["per_layer"]:
        m["workloads"] += [f"tiny-{k}" for k in ("train", "extract", "cluster")
                           if m["name"].endswith(k) or (k == "cluster" and m["name"] == "l1_roofline")]
    if extra_metric is not None:
        (here / "metrics" / "tiny_extra.py").write_text(extra_metric)
        bench["per_layer"].append({"name": "tiny_extra", "unit": "%", "better": "higher",
                                   "source": "device_trace", "layer": "device",
                                   "moves": "extract_img_per_s", "workloads": ["tiny-extract"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
