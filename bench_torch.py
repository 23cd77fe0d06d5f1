#!/usr/bin/env python3
"""Benchmark: ``bench.py``'s config-1 workload through the PyTorch port, on
one card.

Feature extraction (SSG ResNet-50, bf16, 3 parts, random weights from seed
0) of N = 3368 synthetic Market-1501 images in batches of 128, rendered on
the card (``data.synthetic_device.DeviceRenderer``) before the clock
starts, then k-reciprocal re-ranking + auto-eps DBSCAN of the three part
groups (``api.cluster_groups``), each timed after one warm-up pass. The
large-N submetric clusters 16,384 seeded, L2-normalised 2048-d features
(N // 12 identities, noise 0.3) with ``parallel.streaming_cluster`` (chunk
1024). Run from the repository root:

    python3 bench_torch.py

It prints ONE JSON line with ``bench.py``'s keys, in its order.
``vs_baseline`` is ``bench.py``'s: the CPU oracle pipeline measured once
(``BASELINE_MEASURED.json``; extract + 3 x (rerank + eps_dbscan)) over
``value``. Unlike ``bench.py``, a failure of the streaming step is not
caught: it ends the run with a nonzero exit. The labels differ from
``bench.py``'s because the renderers draw from different random streams;
fed the same features, the port's labels are JAX's.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.data.synthetic_device import DeviceRenderer
from ssg_tpu_torch.parallel import streaming

N = 3368
BATCH = 128
STREAMING_N = 16384
HERE = os.path.dirname(os.path.abspath(__file__))
ANALYTICS = dict(k1=20, k2=6, lambda_value=0.1, rho=1.6e-3)


def bench_model(dev: torch.device, **kw):
    """The bf16 SSG ResNet-50 (3 parts, pooled 2048-d embeddings) with
    random weights from seed 0, in eval mode and channels-last on ``dev``."""
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval().to(dev, memory_format=torch.channels_last)


def streaming_features(n: int, dev: torch.device, dim: int = 2048) -> torch.Tensor:
    """(n, dim) L2-normalised fp32 features, n // 12 identity centres plus
    0.3 x noise, from a seeded generator on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = max(n // 12, 1)
    centers = torch.randn((ids, dim), generator=gen, device=dev)
    assign = torch.randint(0, ids, (n,), generator=gen, device=dev)
    f = centers[assign] + 0.3 * torch.randn((n, dim), generator=gen, device=dev)
    return f / f.norm(dim=1, keepdim=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int = N, batch: int = BATCH, streaming_n: int = STREAMING_N, device=None) -> dict:
    """The workload at ``n`` images and ``streaming_n`` streaming points on
    ``device`` (the card unless ``"cpu"``): prints and returns the JSON
    line's dict."""
    dev = resolve_device(device)
    model = bench_model(dev)
    ds = datasets.create("market1501", scale=0.45, seed=0)
    items = (ds.train + ds.query + ds.gallery)[:n]
    if len(items) != n:
        raise ValueError(f"synthetic dataset too small: {len(items)} < {n}")
    batches = list(DeviceRenderer(ds, device=dev).batches(items, batch))
    _sync(dev)

    api.extract_features(model, batches, device=dev)  # warm-up: cuDNN plans, weight casts
    _sync(dev)
    t0 = time.perf_counter()
    feats, _, _, _ = api.extract_features(model, batches, device=dev)
    _sync(dev)
    extract_s = time.perf_counter() - t0

    api.cluster_groups(feats, **ANALYTICS, device=dev)
    t0 = time.perf_counter()
    _, n_clusters, _ = api.cluster_groups(feats, **ANALYTICS, device=dev)
    cluster_s = time.perf_counter() - t0
    total_s = extract_s + cluster_s

    sf = streaming_features(streaming_n, dev)
    skw = dict(**ANALYTICS, min_samples=4, chunk=1024, device=dev)
    streaming.streaming_cluster(sf, **skw)  # labels come back to the host: a completion barrier
    t0 = time.perf_counter()
    _, streaming_clusters, _ = streaming.streaming_cluster(sf, **skw)
    streaming_s = time.perf_counter() - t0

    vs_baseline = None
    baseline_path = os.path.join(HERE, "BASELINE_MEASURED.json")
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            base = json.load(f)
        # The oracle clusters ONE group; compare per-group cost.
        oracle_total = base["extract_seconds"] + 3 * (base["rerank_seconds"]
                                                      + base["eps_dbscan_seconds"])
        vs_baseline = oracle_total / total_s

    out = {
        "metric": "ssg_extract_rerank_dbscan_wallclock_market_query_3368",
        "value": round(total_s, 3),
        "unit": "s",
        "vs_baseline": round(vs_baseline, 1) if vs_baseline else None,
        "extract_seconds": round(extract_s, 3),
        "extract_imgs_per_s": round(n / extract_s, 1),
        "cluster_seconds_3groups": round(cluster_s, 3),
        "clusters": n_clusters,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "streaming_n16384_seconds": round(streaming_s, 3),
        "streaming_n16384_clusters": int(streaming_clusters),
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
