"""Plain k-reciprocal re-ranking, SSG's auto-eps and DBSCAN labels.

Re-ranking follows Zhong et al., CVPR 2017 (arXiv:1701.08398) and its
published code step by step: squared Euclidean distances, each column
divided by its max and the matrix transposed; the k1 + 1 nearest of each
row; the k-reciprocal set R(i) (j among i's and i among j's); each
candidate c in R(i) whose k1/2-reciprocal set Rh(c) shares more than 2/3 of
itself with R(i) adds Rh(c); Gaussian weights exp(-d) over the set,
normalised to sum 1 (V); V averaged over each row's k2 nearest (query
expansion); the Jaccard distance 1 - m / (2 - m) with m = sum_k min(V_ik,
V_jk), summed here over V's nonzero columns, pair by pair; then mixed with
the distance by lambda. Every step works on index lists and sparse
entries, not on the program's dense products.

eps is SSG's rule: the mean of the smallest round(rho M) of the M nonzero
upper-triangle entries. DBSCAN gives sklearn's labels on the eps-graph
``d <= eps`` symmetrised by OR (the program's documented semantics): core
points have at least ``min_samples`` neighbours, self included; clusters
are the connected components of core points, numbered by their smallest
index; a border point joins its first such cluster; the rest is noise -1.

fp32 with TF32 off, or TF32 on for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.resnet import fp32_mode


def _reciprocal(ranks: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Index lists (N, k + 1) of each row's k-reciprocal set, and their mask."""
    n = ranks.shape[0]
    top = ranks[:, :k + 1]
    back = ranks[top][:, :, :k + 1]  # (N, k + 1, k + 1): each neighbour's own list
    keep = (back == torch.arange(n, device=ranks.device)[:, None, None]).any(2)
    return top, keep


def encode(feats: torch.Tensor, k1: int, k2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the normalised distance, the query-expanded V), both (N, N) fp32."""
    n = feats.shape[0]
    sq = (feats * feats).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (feats @ feats.T)).clamp_min(0.0)
    orig = (d / d.amax(0).clamp_min(1e-12)).T.contiguous()
    del d
    ranks = torch.topk(orig, k1 + 1, dim=1, largest=False, sorted=True).indices
    r_idx, r_keep = _reciprocal(ranks, k1)
    half = int(np.around(k1 / 2.0))
    h_idx, h_keep = _reciprocal(ranks, half)
    member = torch.zeros((n, n), dtype=torch.bool, device=feats.device)
    rows = torch.arange(n, device=feats.device)[:, None].expand_as(r_idx)
    member[rows[r_keep], r_idx[r_keep]] = True
    # Candidate c = R(i)[a]: |Rh(c) & R(i)| > 2/3 |Rh(c)|.
    cand_idx, cand_keep = h_idx[r_idx], h_keep[r_idx]  # (N, k1 + 1, half + 1)
    inside = member[torch.arange(n, device=feats.device)[:, None, None], cand_idx] & cand_keep
    qualify = r_keep & (inside.sum(2) > (2.0 / 3.0) * cand_keep.sum(2))
    add = qualify[:, :, None] & cand_keep
    expanded = member.clone()
    rows3 = torch.arange(n, device=feats.device)[:, None, None].expand_as(cand_idx)
    expanded[rows3[add], cand_idx[add]] = True
    del member
    v = torch.where(expanded, torch.exp(-orig), 0.0)
    del expanded
    v = v / v.sum(1, keepdim=True).clamp_min(1e-30)
    if k2 != 1:
        nn2 = ranks[:, :k2]
        qe = torch.empty_like(v)
        for s in range(0, n, 1024):
            qe[s:s + 1024] = v[nn2[s:s + 1024]].mean(1)
        v = qe
    return orig, v


def min_sums(v: torch.Tensor, max_pairs: int = 2**26) -> tuple[torch.Tensor, torch.Tensor]:
    """(m with m[i, j] = sum_k min(V_ik, V_jk), summed over the pairs of each
    column's nonzero entries; V's column counts)."""
    n = v.shape[0]
    col, row = torch.nonzero(v.T, as_tuple=True)  # entries sorted by column
    vals = v[row, col]
    counts = torch.bincount(col, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    entry_pairs = counts[col]  # each entry pairs with every entry of its column
    ends = torch.cumsum(entry_pairs, 0).cpu().numpy()
    m = torch.zeros((n, n), dtype=torch.float32, device=v.device)
    e0 = 0
    while e0 < len(vals):
        base = ends[e0 - 1] if e0 else 0
        e1 = max(int(np.searchsorted(ends, base + max_pairs, side="right")), e0 + 1)
        cnt = entry_pairs[e0:e1]
        a = torch.arange(e0, e1, device=v.device).repeat_interleave(cnt)
        off = torch.arange(a.shape[0], device=v.device) - (
            torch.cumsum(cnt, 0) - cnt).repeat_interleave(cnt)
        b = starts[col[a]] + off
        m.index_put_((row[a], row[b]), torch.minimum(vals[a], vals[b]), accumulate=True)
        e0 = e1
    return m, counts


def rerank(feats: torch.Tensor, k1: int, k2: int, lambda_value: float):
    """(final (N, N) distance, V's column counts)."""
    orig, v = encode(feats, k1, k2)
    m, counts = min_sums(v)
    del v
    jaccard = 1.0 - m / (2.0 - m)
    del m
    final = (jaccard * (1.0 - lambda_value) + orig * lambda_value).clamp_min(0.0)
    return final, counts


def select_eps(d: torch.Tensor, rho: float) -> float:
    n = d.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=d.device).triu_(1)
    vals = d[upper & (d != 0.0)]
    k = max(int(np.round(rho * vals.numel())), 1)
    return float(torch.topk(vals, k, largest=False).values.double().mean())


def dbscan(d: torch.Tensor, eps: float, min_samples: int) -> np.ndarray:
    n = d.shape[0]
    adj = d <= eps
    adj = adj | adj.T
    core = adj.sum(1) >= min_samples
    src, dst = torch.nonzero(adj & core[:, None] & core[None, :], as_tuple=True)
    label = torch.where(core, torch.arange(n, device=d.device), n)
    while True:  # each core point takes the least index it reaches
        new = label.scatter_reduce(0, src, label[dst], reduce="amin")
        new = torch.where(core, new[new.clamp_max(n - 1)], n)  # pointer jumping
        new = torch.minimum(new, label)
        if torch.equal(new, label):
            break
        label = new
    bs, bd = torch.nonzero(adj & ~core[:, None] & core[None, :], as_tuple=True)
    border = torch.full((n,), n, dtype=label.dtype, device=d.device).scatter_reduce(
        0, bs, label[bd], reduce="amin")
    root = torch.where(core, label, border)
    roots = torch.unique(label[core])  # ascending: discovery order
    out = torch.full((n,), -1, dtype=torch.int64, device=d.device)
    hit = root < n
    out[hit] = torch.searchsorted(roots, root[hit])
    return out.cpu().numpy()


def cluster_group(feats: torch.Tensor, k1: int, k2: int, lambda_value: float, rho: float,
                  min_samples: int, allow_tf32: bool = False):
    """(labels (N,) int64 numpy, number of clusters, eps, V's column counts)."""
    with fp32_mode(allow_tf32):
        final, counts = rerank(feats.float(), k1, k2, lambda_value)
        eps = select_eps(final, rho)
        labels = dbscan(final, eps, min_samples)
    return labels, int(labels.max()) + 1, eps, counts.cpu()


def label_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points outside the best match of two labelings (noise, -1,
    a class of its own), the worse of the two directions: 0 for the same
    partition under any renumbering."""
    keys, counts = np.unique(np.stack([a, b]), axis=1, return_counts=True)
    worst = 0.0
    for side in (0, 1):
        best: dict = {}
        for key, c in zip(keys[side].tolist(), counts.tolist()):
            best[key] = max(best.get(key, 0), c)
        worst = max(worst, 1.0 - sum(best.values()) / len(a))
    return worst
