"""Row-sharded distance, eps and DBSCAN over a mesh of ranks.

Counterpart of ``ssg_tpu/parallel/sharded.py``, for (N, N) matrices that
pass one card's memory. A distance matrix lives as row stripes: rank p
holds rows ``p*r:(p+1)*r`` of it as an (r, N) tensor, r = ceil(N / P)
rounded so that P r = npad; rows past N (the last ranks' padding) are
masked out of every decision, never out of a product: counts, top-k scores
and labels ignore them. The numerics are the one-device functions'
(fp32, true fp32 products). Pair counts are int64 (JAX's int32 counts wrap
at N >= 65,537). Every function is collective over the mesh.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.parallel import ring

_MAX_FINITE_BITS = 0x7F7FFFFF  # largest finite fp32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_rows(x: torch.Tensor, mult: int, value=0.0) -> torch.Tensor:
    """``x`` with rows appended (filled with ``value``) to a multiple of ``mult``."""
    n = x.shape[0]
    npad = _round_up(n, mult)
    if npad == n:
        return x
    return torch.cat([x, x.new_full((npad - n, *x.shape[1:]), value)], 0)


def _pad_square(d: torch.Tensor, npad: int, value) -> torch.Tensor:
    """A row stripe (r, N) with columns appended to ``npad``, filled with ``value``."""
    n = d.shape[1]
    if npad == n:
        return d
    return torch.cat([d, d.new_full((d.shape[0], npad - n), value)], 1)


def _global_rows(mesh, r: int, device) -> torch.Tensor:
    """Global row indices of this rank's stripe, shape (r, 1)."""
    return mesh.rank * r + torch.arange(r, device=device)[:, None]


def _rows_of(features: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(all features padded to P r rows, fp32 on the rank's device; this
    rank's rows; n)."""
    f = torch.as_tensor(features).to(mesh.device, torch.float32)
    n = f.shape[0]
    f = _pad_rows(f, mesh.size)
    r = f.shape[0] // mesh.size
    return f, f[mesh.rank * r:(mesh.rank + 1) * r], n


def sqdist_stripe(f_local: torch.Tensor, f_all: torch.Tensor) -> torch.Tensor:
    """Squared-Euclidean rows of ``f_local`` against ``f_all``, the product
    in true fp32 (TF32 off), as JAX's HIGHEST dot."""
    x2 = (f_local * f_local).sum(1, keepdim=True)
    y2 = (f_all * f_all).sum(1)[None, :]
    return (x2 + y2 - 2.0 * (f_local @ f_all.T)).clamp_min(0.0)


def sharded_pairwise_distance(features, mesh, squared: bool = True) -> torch.Tensor:
    """This rank's row stripe (r, N) of the (N, N) squared-Euclidean
    distance of ``features`` (N, D), which every rank holds alike (the
    features are small next to the matrix)."""
    f, f_local, n = _rows_of(features, mesh)
    d = sqdist_stripe(f_local, f)[:, :n]
    return d if squared else d.sqrt()


def sharded_select_eps(dist: torch.Tensor, mesh, rho: float = 1.6e-3) -> torch.Tensor:
    """Sharded twin of ``cluster.select_eps`` on row stripes (r, N): the
    same value; only all-reduced counts touch the matrix. A 0-dim fp32
    tensor, the same on every rank."""
    d = dist.float()
    r, n = d.shape
    rows = _global_rows(mesh, r, d.device)
    cols = torch.arange(n, device=d.device)[None, :]
    valid = (cols > rows) & (rows < n) & (d != 0.0)

    m = ring.all_reduce(mesh, valid.sum())
    rho32 = torch.tensor(rho, dtype=torch.float32, device=d.device)
    k = torch.round(rho32 * m.float()).long().clamp_min(1)
    bits = torch.where(valid, d.view(torch.int32), torch.iinfo(torch.int32).max)
    lo = torch.zeros((), dtype=torch.int64, device=d.device)
    hi = torch.full((), _MAX_FINITE_BITS, dtype=torch.int64, device=d.device)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        take_low = ring.all_reduce(mesh, (bits <= mid).sum()) >= k
        lo = torch.where(take_low, lo, mid + 1)
        hi = torch.where(take_low, mid, hi)
    kth = hi.to(torch.int32).view(torch.float32)

    below = valid & (d < kth)
    cnt_below = ring.all_reduce(mesh, below.sum())
    sum_below = ring.all_reduce(mesh, torch.where(below, d, 0.0).sum())
    total = sum_below + (k - cnt_below).float() * kth
    return total / k.float()


def sharded_dbscan(dist: torch.Tensor, eps, mesh,
                   min_samples: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed DBSCAN on row stripes (r, N): sklearn's labels, as
    ``cluster.dbscan``. The adjacency stays sharded; the (N,) label vector
    is replicated and refreshed by one all-gather a propagation round, with
    one host read a round (the same on every rank).

    Returns (labels (N,) int32, -1 for noise; number of clusters), the same
    on every rank.
    """
    d = dist.float()
    r, n = d.shape
    p = mesh.size
    npad = r * p
    dev = d.device
    big = npad
    d = _pad_square(d, npad, float("inf"))
    rows = _global_rows(mesh, r, dev)
    cols = torch.arange(npad, device=dev)[None, :]
    in_range = (rows < n) & (cols < n)

    adj = (d <= eps) & in_range
    adj = adj | ring.stripe_transpose(mesh, adj.to(torch.uint8)).bool()
    degree = adj.sum(1)
    core_local = degree >= min_samples
    core = ring.all_gather(mesh, core_local)

    gidx = rows[:, 0]
    labels = ring.all_gather(mesh, torch.where(core_local, gidx, big))
    adj_core = adj & core_local[:, None] & core[None, :]

    while True:
        neigh = torch.where(adj_core, labels[None, :], big).amin(1)
        new = ring.all_gather(mesh, torch.minimum(labels[gidx], neigh))
        # Path halving (replicated, cheap).
        hop = torch.where(new < big, new, 0)
        new = torch.where(new < big, torch.minimum(new, new[hop]), new)
        done = torch.equal(new, labels)
        labels = new
        if done:
            break

    # Border points (replicated finish, identical on every rank).
    core_neigh = ring.all_gather(
        mesh, torch.where(adj & core[None, :], labels[None, :], big).amin(1))
    raw = torch.where(core, labels, core_neigh)
    idx = torch.arange(npad, device=dev)
    is_root = core & (labels == idx)
    root_rank = torch.cumsum(is_root.long(), 0) - 1
    out = torch.where(raw < big, root_rank[torch.where(raw < big, raw, 0)], -1)
    return out[:n].to(torch.int32), is_root.sum()


__all__ = ["sharded_pairwise_distance", "sharded_select_eps", "sharded_dbscan",
           "sqdist_stripe"]
