#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 scripts/torch_profile_main_path.py [--fused-eval | --train [--remat]]

Same workload as ``chip_smoke.py`` (bench config-1, N = 3368, 3 groups);
``--fused-eval`` extracts with the same weights and ``fused_eval=True``
(path 2 of ``chip_smoke.py``: the 12 identity bottlenecks of each batch run
the CUDA bottleneck kernel). ``--train`` profiles path 3's train step
instead (T2 of ``chip_smoke.py``: bf16 ResNet-50, batch 64 = P 16 x K 4 at
256x128, inputs on the card): after 5 warm-up steps, a ``torch.profiler``
window over 5 steps, with the device's busy and idle share, the kernels
with the most device time and the device time by kind of kernel;
``--remat`` profiles the same step with ``remat=True`` (each residual
block recomputed in the backward pass).
Otherwise it prints, after a warm-up:

* device time of each stage of ``cluster_groups`` per group (CUDA events,
  median of 5): distance, re-rank encoding (top-k, masks, 0/1 products,
  query expansion), the L1 Jaccard, eps, DBSCAN;
* host time of ``extract_features`` and of ``cluster_groups``;
* a ``torch.profiler`` window over one extract + ``cluster_groups``: the
  kernels with the most device time, the device's busy and idle share of
  the window, and the copy kernels in it (a layout change around the fused
  blocks would show there).

Then one JSON line with these numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
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

from chip_smoke import (ANALYTICS, K1, K2, LAMBDA, MIN_SAMPLES, RHO,  # noqa: E402
                        main_path_inputs, path_model, pk_batch)
from ssg_tpu_torch import api, models, resolve_device  # noqa: E402
from ssg_tpu_torch.data import datasets  # noqa: E402
from ssg_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from ssg_tpu_torch.train.trainer import make_train_step  # noqa: E402
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


def device_kernels(prof) -> list:
    """Device-side events (kernels, copies) of a profile, most time first;
    host ops' times would double count, and so would the device-side spans
    of annotated regions (``Optimizer.step#AdamW.step``), which cover
    kernels already counted: they are left out by the annotations' names."""
    events = prof.key_averages()
    annotations = {e.key for e in events if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and e.key not in annotations]
    return sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)


# Kinds of kernel in a train step, by name (the first match wins).
KINDS = (("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
         ("batch norm", ("batch_norm", "batchnorm", "bn_")),
         ("convolution and matmul", ("conv", "gemm", "cudnn", "sm90", "xmma", "cutlass",
                                     "implicit", "wgrad", "dgrad", "fprop", "nchw", "nhwc")),
         ("copy", ("copy", "memcpy", "memset")),
         ("reduction", ("reduce",)),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def profile_train(dev, smi: str, remat: bool = False) -> int:
    """Path 3's bf16 train step (T2 of chip_smoke.py) under the profiler."""
    ds = datasets.create("dukemtmc", scale=0.2, seed=0)
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev, memory_format=torch.channels_last)
    images, labels = pk_batch(ds, 16, 4)
    images, labels = images.to(dev), labels.to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), num_parts=3,
                           remat=remat)
    gen = torch.Generator(device=dev).manual_seed(2)
    for _ in range(5):
        step(images, labels, gen)
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(images, labels, gen)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"train window: {steps} steps, {window_s * 1e3:.1f} ms host, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / (window_s * 1e3):.1%}), idle "
          f"{1 - busy_ms / (window_s * 1e3):.1%}; {launches / steps:.0f} device launches a step")
    kinds = {name: 0.0 for name, _ in KINDS}
    kinds["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        kind = next((name for name, words in KINDS if any(w in key for w in words)), "other")
        kinds[kind] += e.self_device_time_total / 1e3 / steps
    for name, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms a step  {name}")
    top = []
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"  {ms:8.3f} ms a step  x{e.count // steps:<4} {e.key[:100]}")
        top.append({"kernel": e.key[:100], "ms_per_step": ms, "count_per_step": e.count / steps})
    print(json.dumps({"remat": remat, "train_window_ms_host": window_s * 1e3, "steps": steps,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / (window_s * 1e3),
                      "launches_per_step": launches / steps, "ms_per_step_by_kind": kinds,
                      "top_kernels": top, "card": smi}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--fused-eval", action="store_true",
                      help="extract with fused_eval=True (the CUDA bottleneck kernel)")
    mode.add_argument("--train", action="store_true", help="profile path 3's train step")
    parser.add_argument("--remat", action="store_true",
                        help="with --train: the step with remat=True")
    args = parser.parse_args()
    if args.remat and not args.train:
        parser.error("--remat needs --train")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    if args.train:
        return profile_train(dev, smi, args.remat)
    batches, model = main_path_inputs(dev)
    if args.fused_eval:
        model = path_model(dev, fused_eval=True)
    feats, _, _, _ = api.extract_features(model, batches)
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
    feats, _, _, _ = api.extract_features(model, batches)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.cluster_groups(feats, **ANALYTICS)
    cluster_s = time.perf_counter() - t0
    print(f"host clock: extract {extract_s * 1e3:.1f} ms, cluster_groups {cluster_s * 1e3:.1f} ms")

    def window():
        f, _, _, _ = api.extract_features(model, batches)
        api.cluster_groups(f, **ANALYTICS)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        window_s = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled window {window_s * 1e3:.1f} ms host, device busy {busy_ms:.1f} ms "
          f"({busy_ms / (window_s * 1e3):.1%}), idle {1 - busy_ms / (window_s * 1e3):.1%}")
    top = []
    for e in kernels[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms  x{e.count:<5} {e.key[:100]}")
        top.append({"kernel": e.key[:100], "ms": ms, "count": e.count})
    copies = [e for e in kernels if "copy" in e.key.lower() or "memcpy" in e.key.lower()]
    copy_ms = sum(e.self_device_time_total for e in copies) / 1e3
    print(f"copy kernels: {sum(e.count for e in copies)} launches, {copy_ms:.3f} ms")
    for e in copies[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:100]}")

    print(json.dumps({
        "stages_ms": {k: v for k, v in stages.items()},
        "extract_ms_host": extract_s * 1e3,
        "cluster_groups_ms_host": cluster_s * 1e3,
        "window_ms_host": window_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (window_s * 1e3),
        "top_kernels": top,
        "copy_kernels": {"launches": sum(e.count for e in copies), "ms": copy_ms},
        "fused_eval": args.fused_eval,
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
