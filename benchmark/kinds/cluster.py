"""Clustering: ``api.cluster_groups`` as its defaults call it, over the
part groups' features at a train split's size, pass after pass.

Set-up draws the mix's identities (log-normal skew) and, for each group,
L2-normalised features around identity centres in a low-dimensional
subspace (the frozen feature geometry), on the card from the seed, and
runs one warm-up pass (which builds the program's kernels on a first run
in a checkout). The window runs whole passes (every group's distance,
re-ranking, eps and DBSCAN, the labels on the host) until ``--seconds``
have passed; ``cluster_s`` is the window over its passes. The last pass's
labels and eps are judged against the plain reference's; every pass must
give the first pass's labels.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.features import clustered_features, identities
from benchmark.reference import cluster as ref

ANALYTICS = ("k1", "k2", "lambda_value", "rho", "min_samples")


def setup(cell):
    mix, dev = cell.mix, cell.device
    gen = torch.Generator(device=dev).manual_seed(cell.sub("data"))
    assign = identities(gen, mix["points"], mix["identities"], mix["skew"], dev)
    feats = torch.stack([clustered_features(gen, assign, mix["identities"], mix["dim"],
                                            mix["latent"]) for _ in range(mix["groups"])])
    st = {"feats": feats, "first": None, "last": None}
    _pass(cell, st)
    return st


def _pass(cell, st):
    from ssg_tpu_torch import api

    return api.cluster_groups(st["feats"], device=cell.device,
                              **{k: cell.mix[k] for k in ANALYTICS})


def window(cell, st, seconds: float) -> dict:
    t0 = time.perf_counter()
    passes, differ, units = 0, 0, []
    while True:
        out = _pass(cell, st)
        units.append(time.perf_counter() - t0 - sum(units))
        if st["first"] is None:
            st["first"] = out
        differ += int(not np.array_equal(out[0], st["first"][0]))
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    st["last"] = out
    elapsed = time.perf_counter() - t0
    return {"metrics": {"cluster_s": elapsed / passes}, "attempted": passes, "failed": differ,
            "units": units}


def traced_slice(cell, st) -> dict:
    """One whole pass, as the window runs them."""
    _pass(cell, st)
    n, d, g = cell.mix["points"], cell.mix["dim"], cell.mix["groups"]
    return {"passes": 1, "gram_flops": g * 2.0 * n * n * d}


def collect(cell, st) -> dict:
    labels, counts, eps = st["last"]
    return {"labels": labels, "counts": counts, "eps": eps, "feats": st["feats"]}


def reference(cell, feats, allow_tf32: bool = False) -> list:
    return [ref.cluster_group(feats[g], *(cell.mix[k] for k in ANALYTICS),
                              allow_tf32=allow_tf32) for g in range(feats.shape[0])]


def readings(labels, epss, refs) -> dict:
    """The worst group's relative eps gap and share of points outside the
    best match of the two labelings."""
    eps = [abs(e - r[2]) / r[2] for e, r in zip(epss, refs)]
    gaps = [ref.label_gap(np.asarray(lab), r[0]) for lab, r in zip(labels, refs)]
    return {"eps_gap": float(np.max(eps)), "label_gap": float(np.max(gaps))}  # NaN stays NaN


def check(cell, out) -> tuple[dict, dict]:
    refs = reference(cell, out["feats"])
    extra = {"l1_col_counts": [r[3] for r in refs]}
    return readings(out["labels"], out["eps"], refs), extra


def control(cell, out) -> dict:
    """The reference with TF32 on put in the program's place."""
    base = reference(cell, out["feats"])
    tf32 = reference(cell, out["feats"], allow_tf32=True)
    return readings([r[0] for r in tf32], [r[2] for r in tf32], base)
