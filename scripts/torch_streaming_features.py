#!/usr/bin/env python3
"""How the feature geometry decides the streaming clustering's fast path.

Runs ``streaming_cluster`` on the card at ``chip_smoke.py`` C1's size (the
DukeMTMC train split: 16,522 points of 702 identities, one 2048-d group,
SSG's settings) on seeded clustered features of several geometries, and at
C2's size (the MSMT17 train split: 32,621 points of 1,041 identities) for
two of them, and prints each run's fallback code, candidate counts,
clusters, eps and host seconds (after a warm-up run); then
``streaming_rerank_eval`` at E1's size (the Market-1501 test split) for
several evaluation geometries, with mAP and rank-1. A geometry is the
dimension of the subspace the identity centres are drawn in (2048:
independent directions) and the log-normal sigma of the identity weights
(0: identities evenly sized). The generators are ``chip_smoke.py`` path
5's, seeded as there; its ``EVAL_LATENT``, ``CLUSTER_LATENT`` and
``TRAIN_SKEW`` are among the geometries run here.

    python3 scripts/torch_streaming_features.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ssg_tpu_torch import resolve_device  # noqa: E402
from ssg_tpu_torch.ops import _build  # noqa: E402
from ssg_tpu_torch.parallel import streaming_cluster, streaming_rerank_eval  # noqa: E402

# (n, identities, seed, latent, skew): C1's size, then C2's.
CLUSTER_RUNS = tuple((cs.C1_N, cs.C1_IDS, 12, latent, skew) for latent, skew in
                     ((2048, 0.0), (32, 0.0), (64, 0.8), (32, 0.8), (16, 0.8), (8, 0.8)))
CLUSTER_RUNS += tuple((cs.C2_N, cs.C2_IDS, 13, latent, 0.8) for latent in (32, 16))
EVAL_LATENTS = (32, 16, 8)


def main() -> int:
    dev = resolve_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build(["l1"])
    rows = []
    for n, ids, seed, latent, skew in CLUSTER_RUNS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        assign = cs.identities(gen, n, ids, skew, dev)
        x = cs.clustered_features(gen, assign, ids, 2048, latent)
        streaming_cluster(x, **cs.ANALYTICS)  # warm-up
        diag = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_clusters, eps = streaming_cluster(x, **cs.ANALYTICS, diag=diag)
        seconds = time.perf_counter() - t0
        row = {"n": n, "latent": latent, "skew": skew, "fallback_code": diag["fallback_code"],
               "clusters": n_clusters, "eps": eps, "seconds": seconds,
               "phase_seconds": diag["seconds"],
               **{k: diag[k] for k in ("r_lo", "r_hi", "cand_row_max", "cand_group_max",
                                       "region_tri_pairs")}}
        rows.append(row)
        print(f"N {n} geometry latent {latent} skew {skew}: fallback code "
              f"{row['fallback_code']}, {n_clusters} clusters, eps {eps:.6f}, region "
              f"({row['r_lo']:.4f}, {row['r_hi']:.4f}], candidates a row at most "
              f"{row['cand_row_max']}, a group {row['cand_group_max']}; {seconds:.3f} s")
        del x
    for latent in EVAL_LATENTS:
        qf, gf, q_ids, g_ids, q_cams, g_cams = cs.eval_protocol(dev, latent)
        mAP, cmc, _ = streaming_rerank_eval(qf, gf, q_ids, g_ids, q_cams, g_cams)
        rows.append({"eval_latent": latent, "mAP": mAP, "rank1": float(cmc[0])})
        print(f"E1 geometry latent {latent}: mAP {mAP:.6f}, rank-1 {cmc[0]:.6f}")
    print(json.dumps({"geometries": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
