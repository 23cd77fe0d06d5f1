#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 scripts/torch_profile_main_path.py

Same workload as ``chip_smoke.py`` (bench config-1, N = 3368, 3 groups).
Prints, after a warm-up:

* device time of each stage of ``cluster_groups`` per group (CUDA events,
  median of 5): distance, re-rank encoding (top-k, masks, 0/1 products,
  query expansion), the L1 Jaccard, eps, DBSCAN;
* host time of ``extract_features`` and of ``cluster_groups``;
* a ``torch.profiler`` window over one extract + ``cluster_groups``: the
  kernels with the most device time, and the device's busy and idle share
  of the window.

Then one JSON line with these numbers and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import ANALYTICS, K1, K2, LAMBDA, MIN_SAMPLES, RHO, main_path_inputs  # noqa: E402
from ssg_tpu_torch import api, resolve_device  # noqa: E402
from ssg_tpu_torch.cluster import dbscan, select_eps  # noqa: E402
from ssg_tpu_torch.ops.distance import pairwise_distance  # noqa: E402
from ssg_tpu_torch.ops.rerank import _encode, _re_ranking_impl  # noqa: E402


def device_ms(fn, reps: int = 5):
    """(median device ms over ``reps`` calls, last result)."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    batches, model = main_path_inputs(dev)
    feats, _, _ = api.extract_features(model, batches)
    api.cluster_groups(feats, **ANALYTICS)
    torch.cuda.synchronize()

    stages = {k: [] for k in ("distance", "encode", "l1_jaccard", "eps", "dbscan")}
    for g in range(feats.shape[0]):
        t, original = device_ms(lambda: pairwise_distance(feats[g]))
        stages["distance"].append(t)
        t, _ = device_ms(lambda: _encode(original, K1, K2))
        t_rerank, dist = device_ms(lambda: _re_ranking_impl(original, K1, K2, LAMBDA))
        stages["encode"].append(t)
        stages["l1_jaccard"].append(t_rerank - t)
        t, eps = device_ms(lambda: select_eps(dist, RHO))
        stages["eps"].append(t)
        t, _ = device_ms(lambda: dbscan(dist, eps, MIN_SAMPLES))
        stages["dbscan"].append(t)
    for name, ts in stages.items():
        print(f"{name:>11}: " + ", ".join(f"{t:.3f}" for t in ts) + " ms (groups 0-2)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, _, _ = api.extract_features(model, batches)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.cluster_groups(feats, **ANALYTICS)
    cluster_s = time.perf_counter() - t0
    print(f"host clock: extract {extract_s * 1e3:.1f} ms, cluster_groups {cluster_s * 1e3:.1f} ms")

    def window():
        f, _, _ = api.extract_features(model, batches)
        api.cluster_groups(f, **ANALYTICS)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        window_s = time.perf_counter() - t0
    # Device-side events only (kernels, copies): host ops' times would double count.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled window {window_s * 1e3:.1f} ms host, device busy {busy_ms:.1f} ms "
          f"({busy_ms / (window_s * 1e3):.1%}), idle {1 - busy_ms / (window_s * 1e3):.1%}")
    top = []
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms  x{e.count:<5} {e.key[:100]}")
        top.append({"kernel": e.key[:100], "ms": ms, "count": e.count})

    print(json.dumps({
        "stages_ms": {k: v for k, v in stages.items()},
        "extract_ms_host": extract_s * 1e3,
        "cluster_groups_ms_host": cluster_s * 1e3,
        "window_ms_host": window_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (window_s * 1e3),
        "top_kernels": top,
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
