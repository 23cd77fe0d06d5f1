#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ssg_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_smoke.py

It drives the bench config-1 main path (``bench.py``) through the port's
entry points at full width — SSG ResNet-50 (bf16, random weights from seed
0) extracting 3 part groups from N = 3368 synthetic Market-1501 images in
batches of 128, then per group k-reciprocal re-ranking (k1=20, k2=6,
lambda=0.1), rho-quantile eps (rho=1.6e-3) and DBSCAN (min_samples=4) —
and checks it:

1. builds every CUDA kernel of the path from ``ssg_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card at
   ragged shapes and at the path shape;
3. runs the main path once as warm-up and once timed, with the kernels'
   launch counts set to 0 just before and read just after;
4. checks the output (shapes, finiteness, unit-norm embeddings, labels
   agreeing with the port's CPU path on a subset) and reruns the analytics
   with the plain L1 on the card, which must agree;
5. times each kernel, its plain version and the PyTorch library call that
   computes the same function, at the path shape on the main path's data.

Any failed check ends the run with a nonzero exit. The last three lines are
the kernels' JSON, the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.data import Preprocessor, datasets
from ssg_tpu_torch.ops import _build, l1
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.rerank import _encode, _re_ranking_impl

N = 3368
BATCH = 128
K1, K2, LAMBDA, RHO, MIN_SAMPLES = 20, 6, 0.1, 1.6e-3, 4
ANALYTICS = dict(k1=K1, k2=K2, lambda_value=LAMBDA, rho=RHO, min_samples=MIN_SAMPLES)
L1_TOL = 1e-5  # of the row-sum scale: fp32 sums in another order
# H100 SXM (NVIDIA data sheet): 3.35 TB/s; fp32 67 TFLOP/s counts an FMA as
# two operations, so plain fp32 adds and subtracts (the L1 has no FMA form)
# run at half that: 132 SMs x 128 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP32_NON_FMA_PER_S = 132 * 128 * 1.98e9


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def l1_errors(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    """(max abs error, error / row-sum scale) of the kernel against the plain version."""
    out = l1.l1_distance(x, y)
    ref = l1.l1_distance_ref(x, y)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"L1 kernel output bad at {tuple(x.shape)}x{tuple(y.shape)}")
    err = float((out - ref).abs().max())
    scale = float(x.abs().sum(1).max() + y.abs().sum(1).max())
    return err, err / max(scale, 1e-30)


def l1_bound_ms(m: int, n: int, d: int) -> tuple[float, str]:
    ops_s = 2.0 * m * n * d / FP32_NON_FMA_PER_S
    bytes_s = 4.0 * (m * d + n * d + m * n) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def main_path_inputs(dev: torch.device):
    """The bench config-1 image batches, rendered on the host and uploaded,
    and the bf16 SSG ResNet-50 with random weights from seed 0, on ``dev``."""
    ds = datasets.create("market1501", scale=0.45, seed=0)
    items = (ds.train + ds.query + ds.gallery)[:N]
    check(len(items) == N, f"synthetic dataset too small: {len(items)}")
    t0 = time.perf_counter()
    batches = [(torch.from_numpy(im).to(dev), p, c, mk)
               for im, p, c, mk in Preprocessor(ds, items=items, batch_size=BATCH)]
    torch.cuda.synchronize()
    print(f"render + upload {len(batches)} batches: {time.perf_counter() - t0:.1f} s")
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return batches, model.eval().to(dev, memory_format=torch.channels_last)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. Build.
    t0 = time.perf_counter()
    reports = _build.build(["l1"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}.cu: {line.strip()}")

    # 2. Kernel against its plain version: ragged shapes, then a V-like
    # sparse non-negative input at the path shape.
    gen = torch.Generator(device=dev).manual_seed(0)
    for (m, n, d) in [(1000, 333, 777), (5, 7, 3), (65, 130, 33)]:
        x = torch.randn((m, d), generator=gen, device=dev)
        y = torch.randn((n, d), generator=gen, device=dev)
        err, rel = l1_errors(x, y)
        print(f"l1 ({m},{d})x({n},{d}): max abs err {err:.3e}, rel {rel:.3e}")
        check(rel <= L1_TOL, f"L1 kernel disagrees at ({m},{n},{d}): rel {rel:.3e}")
    cols = torch.randint(0, N, (N, 180), generator=gen, device=dev)
    v_like = torch.zeros((N, N), device=dev).scatter_add_(
        1, cols, torch.rand((N, 180), generator=gen, device=dev))
    v_like /= v_like.sum(1, keepdim=True)
    err, rel = l1_errors(v_like, v_like)
    print(f"l1 V-like ({N},{N})x({N},{N}): max abs err {err:.3e}, rel {rel:.3e}")
    check(rel <= L1_TOL, f"L1 kernel disagrees at the path shape: rel {rel:.3e}")
    del v_like, cols

    # 3. Main path.
    batches, model = main_path_inputs(dev)
    feats, _, _ = api.extract_features(model, batches)
    api.cluster_groups(feats, **ANALYTICS)  # warm-up: cuDNN/cuBLAS plans, kernel load
    torch.cuda.synchronize()

    l1.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats, _, _ = api.extract_features(model, batches)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels, counts, epss = api.cluster_groups(feats, **ANALYTICS)
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    main_launches = l1.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(main_launches == 3, f"L1 kernel launched {main_launches} times in the timed "
                              "cluster_groups, expected 3 (one per group)")

    print(json.dumps({
        "metric": "ssg_extract_rerank_dbscan_wallclock_market_query_3368",
        "value": extract_s + cluster_s,
        "unit": "s",
        "extract_seconds": extract_s,
        "extract_imgs_per_s": N / extract_s,
        "cluster_seconds_3groups": cluster_s,
        "clusters": counts,
        "eps": epss,
        "peak_gib": peak_gib,
        "device": name,
    }))

    # 4. Output checks.
    check(tuple(feats.shape) == (3, N, 2048), f"features shape {tuple(feats.shape)}")
    check(bool(torch.isfinite(feats).all()), "non-finite features")
    norms = feats.norm(dim=-1)
    check(float((norms - 1).abs().max()) < 1e-3, "embeddings are not unit-norm")
    check(labels.shape == (3, N) and labels.dtype == np.int32, "labels shape/type")
    for g in range(3):
        check(labels[g].min() >= -1 and labels[g].max() == counts[g] - 1,
              f"group {g}: labels do not number {counts[g]} clusters")
        check(np.isfinite(epss[g]) and epss[g] > 0, f"group {g}: eps {epss[g]}")
    check(sum(counts) > 0, "no clusters found")

    # Against the port's CPU path (plain versions throughout) on a subset.
    # Both re-rank the same squared-distance matrix: distances computed apart
    # differ in the last bits, and among the near-tied neighbours of random-
    # weight features that may swap a rank and so change V legitimately.
    # Then both cluster the same re-ranked matrix: identical eps and labels.
    for g in range(3):
        original = pairwise_distance(feats[g, :400])
        d_card = _re_ranking_impl(original, K1, K2, LAMBDA)
        d_cpu = _re_ranking_impl(original.cpu(), K1, K2, LAMBDA)
        gap = float((d_card.cpu() - d_cpu).abs().max())
        lab_card, n_card, eps_card = api.cluster(d_card, rho=0.02)
        lab_cpu, n_cpu, eps_cpu = api.cluster(d_card.cpu(), rho=0.02, device="cpu")
        print(f"subset group {g} N={original.shape[0]}: re-rank card vs CPU max gap "
              f"{gap:.2e}; {n_card} clusters, eps {eps_card:.6g} vs {eps_cpu:.6g}")
        check(gap <= 1e-5, f"group {g}: re-ranked distances differ by {gap:.2e} on the subset")
        check(np.array_equal(lab_card, lab_cpu) and n_card == n_cpu
              and abs(eps_card - eps_cpu) <= 1e-6 * eps_cpu,
              f"group {g}: card and CPU cluster the same matrix differently")

    # The same analytics with the plain L1 on the card.
    plain = api.cluster_groups(feats, **ANALYTICS, l1_impl="torch")
    check(plain[1] == counts, f"plain-L1 cluster counts {plain[1]} != {counts}")
    check(np.allclose(plain[2], epss, rtol=1e-5, atol=0), f"plain-L1 eps {plain[2]} != {epss}")
    agree = float((plain[0] == labels).mean())
    print(f"plain-L1 path: label agreement {agree:.6f}, eps {plain[2]}")
    if agree < 1.0:
        for g in range(3):
            dist = _re_ranking_impl(pairwise_distance(feats[g]), K1, K2, LAMBDA)
            near = int(((dist - epss[g]).abs() <= 1e-5 * epss[g]).sum())
            print(f"  group {g}: {near} re-ranked entries within 1e-5 of eps")
    check(agree >= 0.999, f"labels agree on only {agree:.4%} of points")

    # 5. Kernel timing at the path shape, on group 0's encoding V.
    _, v = _encode(pairwise_distance(feats[0]), K1, K2)
    err, rel = l1_errors(v, v)
    check(rel <= L1_TOL, f"L1 kernel disagrees on the main path's V: rel {rel:.3e}")
    before = l1.launches
    kernel_ms = cuda_ms(lambda: l1.l1_distance(v, v), 20)
    plain_ms = cuda_ms(lambda: l1.l1_distance_ref(v, v), 3)
    library_ms = cuda_ms(lambda: torch.cdist(v, v, p=1), 5)
    check(l1.launches - before == 21, "kernel timing did not launch the kernel")
    bound_ms, bound_by = l1_bound_ms(v.shape[0], v.shape[0], v.shape[1])
    print(f"l1 at ({N},{N})x({N},{N}): kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.cdist {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
          f"{bound_ms / kernel_ms:.1%} of bound")

    print(json.dumps({"kernels": [{
        "name": "l1_distance",
        "route": "cuda",
        "source": "ssg_tpu_torch/csrc/l1.cu",
        "replaces": "ssg_tpu/ops/l1.py:27",
        "launches": main_launches,
        "max_abs_err": err,
        "max_err": rel,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "ref_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
