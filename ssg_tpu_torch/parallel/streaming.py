"""Streaming k-reciprocal clustering and re-ranked evaluation for large N.

Counterpart of ``ssg_tpu/parallel/streaming.py``, on one device or over a
mesh of ranks (``parallel/mesh.py``). The dense
chain (``ops/rerank.py`` + ``cluster/``) keeps some thirty N^2-byte buffers
alive at once; this pipeline keeps one fp32 V (and its query-expanded
successor while it is built), bf16 copies of rh and V and bit-packed
adjacency, and recomputes distance rows chunk by chunk from the features:

  phase 1  rank lists + column max:  chunked distance GEMMs, top-k a chunk.
           After it, reciprocity of any pair is recomputable from the
           (N, k) lists alone.
  phase 2  V:                        per chunk, the masks from the lists,
           the 2/3 expansion by bf16 mask GEMMs against rh, Gaussian
           weights; then query expansion by a k2-row gather-sum.
  phase 3  eps:                      one bound-and-correct main sweep. A
           sampled chunk estimates the eps region (r_lo, r_hi]; per chunk a
           bf16 mask-GEMM lower bound fd_lb <= fd (``ops/minsum.py``) prunes
           every pair with fd_lb > r_hi; the few survivors are compacted
           (exact top-k) and their exact distances come from compacted
           (idx, val) V tables. The k-th value and eps then come from the
           compacted view in closed form (a two-level histogram); exact
           post-hoc checks (the k-th pair inside the region, no candidate or
           support overflow, eps inside the region) send a failure to the
           exact fallback sweeps, which use the L1 kernel over V.
  phase 4  DBSCAN:                   adjacency (final <= eps), bit-packed,
           then min-label propagation and a border pass (sklearn's labels).
           On the fast path every adjacency pair is already a compacted
           candidate (fd <= eps <= r_hi), so it is scattered from the slots.

The JAX package's ``lax.cond`` and ``while_loop`` become Python branches on
a host read: one read after the main sweep, one after eps, one a DBSCAN
round; no read falls inside a chunk loop. Pair counts are int64 (the JAX
package's int32 counts wrap at N >= 65,537).

Over a mesh of P ranks each rank holds the row stripe ``row0 = rank * r``,
``r = npad / P`` of every (N, N) state, as JAX's shard_map does: the rank
lists, the rh sizes, the row sums and the compacted V tables are
all-gathered, the column maximum, the counts, histograms and flags are
all-reduced (``parallel/ring.py``), and the stripe primitives
(``parallel/_stripe.py``) rotate the other ranks' stripes past this one.
The phase-3 sample takes one chunk a rank, so on P ranks it takes JAX's
rows on ``make_mesh(P)``. Every flag that decides a branch is reduced
before its host read, so all ranks take the same branch and their
collectives stay aligned. Query expansion and the phase-2 rh products
rotate each stripe once and serve every chunk a visit (JAX rotates them
once a chunk): each output adds the same terms in the same order.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.ops.bits import pack_bits, popcount, unpack_bits
from ssg_tpu_torch.ops.l1 import l1_distance
from ssg_tpu_torch.ops.metrics import rank_stats_hits, rank_stats_masked
from ssg_tpu_torch.ops.minsum import (bound_product, compact_rows, fd_lower, minsum_upper,
                                      sparse_minsum_pairs, support_mask)
from ssg_tpu_torch.ops.topk import exact_min_k
from ssg_tpu_torch.parallel import ring
from ssg_tpu_torch.parallel._stripe import ring_contract, ring_pairwise, stripe_transpose_packed

_BINS = 8192
# Coarse bins for the phase-3 sample histogram: it only locates the eps
# region (exact checks verify it post hoc), and its noise floor is the
# sampling error, so 64 * w0-wide bins lose nothing.
_BINS_S = _BINS // 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _group_geometry(b: int, cap: int) -> tuple[int, int]:
    """(g_rows, gcap) for the main sweep's grouped slot compaction.

    Per-row compaction would budget ``cap`` for the worst row, while the
    mean is far lower, so G = 8 rows' slots re-compact into gcap = 2 cap.
    Group overflow is an exact count check routed to the same fallback as
    per-row overflow. G shrinks to keep dividing the chunk; cap == 0 (the
    fused path disabled) means no grouping.
    """
    g_rows = 8 if b % 8 == 0 else (4 if b % 4 == 0 else (2 if b % 2 == 0 else 1))
    if cap == 0:
        return 1, 0
    return g_rows, min(2 * cap, g_rows * cap)


def _default_eps_cap(g_rows: int, gcap: int) -> int:
    """Default grouped eps-compaction width (slots a slot-row). The capacity
    a matrix row, ecap / g_rows, never falls below the per-row budget cap // 8."""
    return min(max(64, _round_up(gcap // 2, 64)), max(gcap, 1))


def _tier_width(gcap: int) -> int:
    """Head tier of the exact S x S correction: slots are live first
    (ascending bound), and the mean live count is well below gcap, so the
    main sweep corrects the head tier of every chunk and the tail only for
    chunks where a group's exact count exceeds it. Small caps take no tier."""
    return gcap if gcap <= 256 else min(_round_up(max(gcap // 3, 256), 64), gcap)


def _hist(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """int64 counts of ``idx`` in [0, nbins]; bin ``nbins`` takes the masked
    entries and is dropped. A scatter-add: ``torch.bincount`` reads its
    input's maximum back to the host."""
    idx = idx.reshape(-1)
    ones = torch.ones((), dtype=torch.int64, device=idx.device).expand(idx.shape)
    return torch.zeros(nbins + 1, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, idx, ones)[:nbins]


def _bin_sums(idx: torch.Tensor, vals: torch.Tensor, nbins: int) -> torch.Tensor:
    """fp32 sums of ``vals`` by bin, as ``_hist``."""
    return torch.zeros(nbins + 1, dtype=torch.float32, device=vals.device) \
        .index_add_(0, idx.reshape(-1), vals.reshape(-1))[:nbins]


def _bin_mins(idx: torch.Tensor, vals: torch.Tensor, nbins: int) -> torch.Tensor:
    return torch.full((nbins + 1,), float("inf"), dtype=torch.float32, device=vals.device) \
        .scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1), "amin")[:nbins]


def _to_bin(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """clip(int(x), 0, nbins - 1): truncation toward zero, as XLA's convert."""
    return x.to(torch.int64).clamp_(0, nbins - 1)


def _at(cum: torch.Tensor, i: torch.Tensor, default) -> torch.Tensor:
    """cum[i - 1] where i > 0, else ``default`` (indices clamped, as XLA's)."""
    return torch.where(i > 0, cum[(i - 1).clamp(0, cum.shape[0] - 1)], default)


def _member_chunk(lists_rows: torch.Tensor, npad: int) -> torch.Tensor:
    """(B, k) per-row index lists -> (B, npad) bool membership."""
    out = torch.zeros((lists_rows.shape[0], npad), dtype=torch.bool, device=lists_rows.device)
    return out.scatter_(1, lists_rows, True)


def _recip_chunk(lists_all: torch.Tensor, row0: int, b: int, npad: int) -> torch.Tensor:
    """Reciprocal membership for rows [row0, row0 + b): mask[i, j] =
    (j in lists[i]) & (i in lists[j]), built from the (N, k) lists alone.
    The backward half scatters every list entry that names a row of the
    chunk (the JAX package compares every list against the chunk's rows)."""
    fwd = _member_chunk(lists_all[row0:row0 + b], npad)
    loc = lists_all - row0
    hit = (loc >= 0) & (loc < b)
    cols = torch.arange(npad, device=lists_all.device)[:, None].expand_as(loc)
    bwd = torch.zeros((b + 1, npad), dtype=torch.bool, device=lists_all.device)
    bwd[torch.where(hit, loc, b), cols] = True  # row b takes the misses
    return fwd & bwd[:b]


def _phases12(f, n, k1, k2, lambda_value, b, n_vblk, l1_impl, support_cap=0, valid=None,
              mesh=None):
    """Phases 1-2 (rank lists + V), shared by the clustering and the
    evaluation pipelines. Returns the closures that compute re-ranked
    distance rows of this rank's stripe chunk by chunk, the row validity
    and the stripe's first row.

    ``f`` is (npad, D) fp32, every rank's copy alike, with npad a multiple
    of P ``b``; the rank's stripe is rows ``row0 = rank * r`` to
    ``row0 + r``, ``r = npad / P``. Rows are valid where ``valid`` says, or
    below ``n`` (the clustering path pads rows as a suffix). With
    ``support_cap > 0`` the element ``bound_ctx`` is the bound-and-correct
    machinery of the main sweep (``ops/minsum.py``): the stripe's V rows
    compacted to (idx, val) tables (all-gathered), a bf16 V for the
    screening product, and the ``bound_chunk`` / ``slot_fd_pairs``
    closures; ``bound_ctx["sup_ovf"]`` flags a V row of the stripe whose
    support exceeds the compaction width (the caller reduces it over the
    ranks and then takes the exact fallback)."""
    npad = f.shape[0]
    dev = f.device
    p, me = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    r = npad // p
    row0 = me * r
    f_loc = f[row0:row0 + r]
    n_chunks = r // b
    half = int(round(k1 / 2.0))
    cb = npad // n_vblk  # V and rh are stored as n_vblk column blocks
    y2 = (f * f).sum(1)
    ids = torch.arange(npad, device=dev)
    col_valid = ids < n if valid is None else valid
    grows = ids[row0:row0 + r]  # the stripe's global rows

    def blocks(x):
        return tuple(x[:, i * cb:(i + 1) * cb] for i in range(n_vblk))

    def sqdist(fc):
        """Squared-Euclidean distances of rows ``fc`` against all, the
        product in true fp32 (TF32 off), as JAX's HIGHEST dot."""
        x2 = (fc * fc).sum(1, keepdim=True)
        return (x2 + y2[None, :] - 2.0 * (fc @ f.T)).clamp_min(0.0)

    def dist_chunk(c):
        return sqdist(f_loc[c * b:(c + 1) * b])

    # ---- phase 1: rank lists + column max -------------------------------
    nn1 = torch.empty((r, k1 + 1), dtype=torch.int64, device=dev)
    nn2 = None if k2 <= k1 + 1 else torch.empty((r, k2), dtype=torch.int64, device=dev)
    colmax = torch.full((npad,), float("-inf"), device=dev)
    for c in range(n_chunks):
        rows = slice(c * b, (c + 1) * b)
        d = dist_chunk(c)
        score = torch.where(col_valid[None, :], d, float("inf"))
        # Sorted neighbours: the k1/2 and k2 lists are prefixes.
        nn1[rows] = exact_min_k(score, k1 + 1)[1]
        if nn2 is not None:
            nn2[rows] = exact_min_k(score, k2)[1]
        colmax = torch.maximum(
            colmax, torch.where(col_valid[grows[rows], None], d, float("-inf")).amax(0))
    colmax = ring.all_reduce(mesh, colmax, "max").clamp_min(1e-12)
    nn1_all = ring.all_gather(mesh, nn1)
    nnh_all = nn1_all[:, :half + 1]
    nnh = nn1[:, :half + 1]
    if nn2 is None:
        nn2 = nn1[:, :k2]

    # rh as bf16 column blocks of the stripe (the operand of the expansion
    # GEMMs).
    rhbf_blks = tuple(torch.empty((r, cb), dtype=torch.bfloat16, device=dev)
                      for _ in range(n_vblk))
    for c in range(n_chunks):
        rows = slice(c * b, (c + 1) * b)
        m = (_recip_chunk(nnh_all, row0 + c * b, b, npad) & col_valid[grows[rows], None]
             & col_valid[None, :])
        for blk, mb in zip(rhbf_blks, blocks(m)):
            blk[rows] = mb
    # |Rh(i)| from the lists: every member j of nnh[i] with i in nnh[j]
    # (the lists hold distinct indices, as exact top-k gives them).
    recip_m = (nnh_all[nnh] == grows[:, None, None]).any(-1)
    szl = (recip_m & col_valid[nnh]).float().sum(1)
    sz = ring.all_gather(mesh, torch.where(col_valid[grows], szl, 0.0))

    # ---- phase 2: V (column blocks) -------------------------------------
    row_scale = colmax[row0:row0 + r]

    def gemm_t(x, y):  # overlap[i, c] = sum_k x[i, k] y[c, k]
        return x @ y.T

    def recip(c):
        return _recip_chunk(nn1_all, row0 + c * b, b, npad) & col_valid[None, :]

    counts = None
    if p > 1:
        # Over ranks the rh stripes rotate once a contraction, not once a
        # chunk: each visit adds its tiles to every chunk's integer counts
        # (uint8 and int16 hold them exactly; the per-chunk form's bf16
        # products of 0/1 operands are the same integers), so the overlap,
        # qualify and expansion are the per-chunk form's, bit for bit.
        ctype = torch.uint8 if k1 + 1 <= 255 else torch.int16
        overlap_all = torch.zeros((r, npad), dtype=ctype, device=dev)
        for i, rhb in enumerate(rhbf_blks):
            block = rhb
            for s in range(p):
                cols = slice(((me - s) % p) * r, ((me - s) % p + 1) * r)
                for c in range(n_chunks):
                    rb = blocks(recip(c))[i].to(torch.bfloat16)
                    overlap_all[c * b:(c + 1) * b, cols] += gemm_t(rb, block).to(ctype)
                if s + 1 < p:
                    block = ring.shift(mesh, block)
        qualify_all = torch.empty((r, npad), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            rows = slice(c * b, (c + 1) * b)
            qualify_all[rows] = recip(c) & (overlap_all[rows].float() > (2.0 / 3.0) * sz[None, :])
        del overlap_all
        counts = tuple(torch.zeros((r, cb), dtype=ctype, device=dev) for _ in range(n_vblk))
        for cnt, rhb in zip(counts, rhbf_blks):
            block = rhb
            for s in range(p):
                cols = slice(((me - s) % p) * r, ((me - s) % p + 1) * r)
                for c in range(n_chunks):
                    rows = slice(c * b, (c + 1) * b)
                    q = qualify_all[rows, cols].to(torch.bfloat16)
                    cnt[rows] += (q @ block).to(ctype)
                if s + 1 < p:
                    block = ring.shift(mesh, block)
        del qualify_all

    v_blks = tuple(torch.empty((r, cb), device=dev) for _ in range(n_vblk))
    for c in range(n_chunks):
        rows = slice(c * b, (c + 1) * b)
        orig = dist_chunk(c) / row_scale[rows, None]
        r_chunk = recip(c)
        r_chunk_blks = blocks(r_chunk)
        if counts is not None:
            expanded = torch.cat([rb | (cnt[rows] > 0) for rb, cnt in zip(r_chunk_blks, counts)],
                                 1)
        else:
            # overlap is additive over column blocks.
            overlap = sum(ring_pairwise(rb.to(torch.bfloat16), rhb, gemm_t, mesh)
                          for rb, rhb in zip(r_chunk_blks, rhbf_blks))
            qualify = (r_chunk & (overlap > (2.0 / 3.0) * sz[None, :])).to(torch.bfloat16)
            expanded = torch.cat([r_chunk_blks[i] | (ring_contract(qualify, rhb, mesh) > 0.0)
                                  for i, rhb in enumerate(rhbf_blks)], 1)
        w = torch.where(expanded, torch.exp(-orig), 0.0)
        v = w / w.sum(1, keepdim=True).clamp_min(1e-30)
        for blk, vb in zip(v_blks, blocks(v)):
            blk[rows] = vb
    del rhbf_blks, counts

    # Query expansion: a k2-row gather-sum. Each V block rotates once over
    # the ranks; a visit adds its rows to every chunk, t ascending, in JAX's
    # owner order (adding a masked 0 is exact), as JAX's per-chunk ring does.
    if k2 != 1:
        vqe = tuple(torch.zeros((r, cb), device=dev) for _ in range(n_vblk))
        for blk, vb in zip(vqe, v_blks):
            block = vb
            for s in range(p):
                owner = (me - s) % p
                for c in range(n_chunks):
                    rows = slice(c * b, (c + 1) * b)
                    ring.gather_sum_visit(blk[rows], nn2[rows], block, owner * r)
                if s + 1 < p:
                    block = ring.shift(mesh, block)
            blk /= float(k2)
        v_blks = vqe
    s_all = ring.all_gather(mesh, sum(vb.sum(1) for vb in v_blks))

    def l1_tile(x, y):
        return l1_distance(x, y, impl=l1_impl)

    def _finalize(fc, scale_rows, vc_blks):
        """Re-ranked distances of the given feature / V rows against all."""
        orig = sqdist(fc) / scale_rows[:, None]
        # ||V_i - V_j||_1 is additive over column blocks.
        l1 = sum(ring_pairwise(vcb, vb, l1_tile, mesh) for vcb, vb in zip(vc_blks, v_blks))
        s_mine = sum(vcb.sum(1) for vcb in vc_blks)
        min_sum = 0.5 * (s_mine[:, None] + s_all[None, :] - l1)
        jaccard = 1.0 - min_sum / (2.0 - min_sum)
        return (jaccard * (1.0 - lambda_value) + orig * lambda_value).clamp_min(0.0)

    def final_chunk(c):
        """(b, npad) final re-ranked distances of the stripe's chunk c."""
        rows = slice(c * b, (c + 1) * b)
        return _finalize(f_loc[rows], row_scale[rows], tuple(vb[rows] for vb in v_blks))

    def final_rows(rows):
        """``final_chunk`` for the non-contiguous stripe rows ``rows`` (the
        phase-3 sample spreads its rows over the whole stripe)."""
        return _finalize(f_loc[rows], row_scale[rows], tuple(vb[rows] for vb in v_blks))

    def rows_valid(rows):
        """Upper-triangle pairs of the global ``rows`` whose row and column
        are valid."""
        return (ids[None, :] > rows[:, None]) & col_valid[rows][:, None] & col_valid[None, :]

    def chunk_valid(c):
        return rows_valid(grows[c * b:(c + 1) * b])

    bound_ctx = None
    if support_cap > 0:
        s_sup = min(int(support_cap), npad)
        vbf_blks = tuple(vb.to(torch.bfloat16) for vb in v_blks)
        cidx = torch.empty((r, s_sup), dtype=torch.int64, device=dev)
        cval = torch.empty((r, s_sup), device=dev)
        sup_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            rows = slice(c * b, (c + 1) * b)
            vrow = torch.cat([vb[rows] for vb in v_blks], 1)  # (b, npad)
            sup_ovf |= ((vrow > 0.0).sum(1) > s_sup).any()
            cidx[rows], cval[rows] = compact_rows(vrow, s_sup)
        # The compacted V is small enough to hold everywhere, so the exact
        # correction gathers locally.
        cidx_all = ring.all_gather(mesh, cidx)
        cval_all = ring.all_gather(mesh, cval)

        def bound_chunk(c):
            """(fd_lb, orig) for chunk c: a sound lower bound on the re-ranked
            distance from the bf16 mask-product upper bound on ms."""
            rows = slice(c * b, (c + 1) * b)
            orig = dist_chunk(c) / row_scale[rows, None]
            g = sum(ring_pairwise(support_mask(vb[rows]), vbf, bound_product, mesh)
                    for vb, vbf in zip(v_blks, vbf_blks))
            return fd_lower(minsum_upper(g), orig, lambda_value), orig

        def slot_fd_pairs(c, rowl, cols, o):
            """Exact re-ranked distance of grouped slots of chunk c: ``rowl``
            (bg, Q) row in the chunk and ``cols`` (bg, Q) column of each slot,
            ``o`` their normalised distances, from the compacted tables."""
            rg = c * b + rowl
            ms = sparse_minsum_pairs(cidx[rg], cval[rg], cidx_all[cols], cval_all[cols])
            jac = 1.0 - ms / (2.0 - ms)
            return (jac * (1.0 - lambda_value) + o * lambda_value).clamp_min(0.0)

        bound_ctx = {"bound_chunk": bound_chunk, "slot_fd_pairs": slot_fd_pairs,
                     "sup_ovf": sup_ovf}

    return final_chunk, final_rows, rows_valid, chunk_valid, col_valid, row0, bound_ctx


def _cluster_one(f, n, rho, k1, k2, lambda_value, min_samples, b, l1_impl, n_vblk,
                 with_final, band_cap, support_cap, eps_cap, timed=False, mesh=None):
    """The streaming pipeline for one feature group, on this rank's stripe.
    Returns (labels (n,), n_clusters, eps, band_fallback, fallback_code,
    diag_vec (9,), final, seconds), the same on every rank. With ``timed``,
    ``seconds`` holds each phase's host-clock seconds, the device
    synchronised at each phase's end (six reads); otherwise it is empty."""
    npad = f.shape[0]
    dev = f.device
    p = 1 if mesh is None else mesh.size
    r = npad // p
    seconds = {}
    t_last = [time.perf_counter()]

    def phase_end(name):
        if timed:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            seconds[name] = now - t_last[0]
            t_last[0] = now

    n_chunks = r // b
    cap = min(band_cap, npad)
    g_rows, gcap = _group_geometry(b, cap)
    (final_chunk, final_rows, rows_valid, chunk_valid, col_valid, row0,
     bound_ctx) = _phases12(f, n, k1, k2, lambda_value, b, n_vblk, l1_impl,
                            support_cap=support_cap if cap > 0 else 0, mesh=mesh)
    final = (ring.all_gather(mesh, torch.cat([final_chunk(c) for c in range(n_chunks)]))
             if with_final else None)
    phase_end("phases12")
    rho32 = torch.tensor(rho, dtype=torch.float32, device=dev)

    # ---- phase 3: sampled region, then one bound-and-correct sweep -------
    hi0 = torch.tensor(1.0 + lambda_value, dtype=torch.float32, device=dev)
    w0 = hi0 / _BINS

    def cidx(fd):
        return _to_bin(fd / w0, _BINS)

    # One chunk's worth of rows a rank, spread over its stripe as a
    # golden-ratio Weyl sequence (a coprime multiplier, so i -> i c mod r is
    # a bijection): a contiguous chunk of identity-ordered features is a
    # biased sample. The multiplier is the JAX package's, so the two sample
    # the same rows on a mesh of the same size.
    c_mul = max(int(round(0.6180339887 * r)) | 1, 1)
    while math.gcd(c_mul, r) != 1:
        c_mul += 2
    rows_s = torch.as_tensor(np.fromiter(((i * c_mul) % r for i in range(b)), np.int64, count=b),
                             device=dev)
    fd0 = final_rows(rows_s)
    tri0 = rows_valid(row0 + rows_s) & (fd0 != 0.0)
    # Coarse sample bins (64 w0 wide) locate the k-th bin; a second level
    # re-histograms it at w0 / 2; the value sums below it are exact.
    w_s = hi0 / _BINS_S
    ci_s = _to_bin(fd0 / w_s, _BINS_S)
    hs = ring.all_reduce(mesh, _hist(torch.where(tri0, ci_s, _BINS_S), _BINS_S))
    k_s = torch.round(rho32 * hs.sum().float()).long().clamp_min(1)
    cum_s = torch.cumsum(hs, 0)
    b_s = torch.searchsorted(cum_s, k_s).clamp_max(_BINS_S - 1)
    below_s = _at(cum_s, b_s, torch.zeros_like(k_s))
    w_f = w_s / _BINS_S
    lo_s = b_s.float() * w_s
    in_b = tri0 & (ci_s == b_s)
    fi_s = _to_bin((fd0 - lo_s) / w_f, _BINS_S)
    cum_f = below_s + torch.cumsum(
        ring.all_reduce(mesh, _hist(torch.where(in_b, fi_s, _BINS_S), _BINS_S)), 0)
    b_f = torch.searchsorted(cum_f, k_s).clamp_max(_BINS_S - 1)
    kth_lo = lo_s + b_f.float() * w_f
    kth_hi = kth_lo + w_f
    below_f = _at(cum_f, b_f, below_s)
    sum_below_f = ring.all_reduce(
        mesh, torch.where(tri0 & ((ci_s < b_s) | (in_b & (fi_s < b_f))), fd0, 0.0).sum())
    rem_s = (k_s - below_f).clamp_min(0).float()
    ksf = k_s.float()
    e_lo = (sum_below_f + rem_s * kth_lo) / ksf
    e_hi = (sum_below_f + rem_s * kth_hi) / ksf
    # The lower edge guards eps (a mean of the k smallest, with the sample
    # noise of the whole distribution below the k-th), so it gets double the
    # slack of the upper edge. Slack is in w0 units.
    slack = 64.0 * w0
    r_lo = (torch.minimum(e_lo, kth_lo) - 2.0 * slack).clamp_min(0.0)
    r_hi = torch.maximum(kth_hi, e_hi) + slack
    phase_end("sample")

    # ---- main sweep: bound screen + exact correction + compaction --------
    # Every pair is screened by fd_lb <= fd; the few survivors of
    # fd_lb <= r_hi are compacted a group of g_rows strided rows at a time,
    # and only they get their exact distance. Pruned pairs are nonzero
    # (fd >= fd_lb > r_hi > 0) and only count toward the pair total.
    bg = b // g_rows
    xt = _tier_width(gcap)
    width = max(gcap, 1)
    ng = r // g_rows
    cand_col = torch.full((ng, width), npad, dtype=torch.int64, device=dev)
    cand_fd = torch.full((ng, width), float("inf"), device=dev)
    cand_row = torch.zeros((ng, width), dtype=torch.int64, device=dev)
    tiered = xt < gcap
    if tiered:
        # The tail tier is corrected after the sweep, for the chunks whose
        # exact group counts need it: one host read, not one a chunk. It
        # keeps each slot's normalised distance and liveness until then.
        cand_o = torch.empty((ng, width), device=dev)
        cand_live = torch.empty((ng, width), dtype=torch.bool, device=dev)
        need_tail = torch.empty(n_chunks, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pruned, rmax, rsum, gmax = zero, zero, zero, zero
    ovf = torch.tensor(cap == 0, device=dev)
    grp = torch.arange(bg, device=dev)[:, None]
    for c in range(n_chunks):
        rows = torch.arange(row0 + c * b, row0 + (c + 1) * b, device=dev)
        if cap > 0:
            ok = (rows[:, None] < n) & col_valid[None, :]
            fd_lb, orig = bound_ctx["bound_chunk"](c)
            candm = ok & (fd_lb <= r_hi)
            pruned = pruned + (chunk_valid(c) & ~candm).sum()
            cand_rows = candm.sum(1)
            rmax = torch.maximum(rmax, cand_rows.max())
            rsum = rsum + cand_rows.sum()
            key = torch.where(candm, fd_lb, float("inf"))
            # Group i holds the strided rows i, i + bg, ...: adjacent rows of
            # identity-ordered features share a cluster, and strided groups
            # do not overflow in lockstep.
            keyg = key.reshape(g_rows, bg, npad).transpose(0, 1).reshape(bg, g_rows * npad)
            cnt_g = cand_rows.reshape(g_rows, bg).sum(0)  # exact live count a group
            ovf = ovf | (cnt_g > gcap).any()
            gmax = torch.maximum(gmax, cnt_g.max())
            lbg, flat = exact_min_k(keyg, gcap)
            rowg = flat // npad  # row in the group
            colg = flat - rowg * npad
            rowl = rowg * bg + grp  # row in the chunk
            o = orig.reshape(-1)[rowl * npad + colg]
            fd_s = torch.full((bg, gcap), float("inf"), device=dev)
            fd_s[:, :xt] = bound_ctx["slot_fd_pairs"](c, rowl[:, :xt], colg[:, :xt], o[:, :xt])
            sl = slice(c * bg, (c + 1) * bg)
            live = torch.isfinite(lbg)
            cand_col[sl] = colg
            cand_fd[sl] = torch.where(live, fd_s, float("inf"))
            cand_row[sl] = rowg
            if tiered:
                need_tail[c] = (cnt_g > xt).any()
                cand_o[sl] = o
                cand_live[sl] = live
        else:
            # cap = 0 disables the fused path: one exact sweep still gives
            # the nonzero-pair total that sizes k; eps and adjacency then
            # take the fallback sweeps.
            fd = final_chunk(c)
            pruned = pruned + (chunk_valid(c) & (fd != 0.0)).sum()
    if tiered:
        for c in torch.nonzero(need_tail).flatten().tolist():
            sl = slice(c * bg, (c + 1) * bg)
            rowl = cand_row[sl, xt:] * bg + grp
            fd_t = bound_ctx["slot_fd_pairs"](c, rowl, cand_col[sl, xt:], cand_o[sl, xt:])
            cand_fd[sl, xt:] = torch.where(cand_live[sl, xt:], fd_t, float("inf"))

    # Slot statistics (exact values for every pair with fd <= r_hi). Slot-row
    # a holds chunk a // bg's group a % bg, whose row t is chunk row
    # t bg + a % bg; rows_loc is the stripe row.
    arow = torch.arange(ng, device=dev)[:, None]
    rows_loc = (arow // bg) * b + (arow % bg) + cand_row * bg
    live = torch.isfinite(cand_fd)
    slot_tri = live & (cand_fd != 0.0) & (cand_col > row0 + rows_loc)
    below_m = slot_tri & (cand_fd <= r_lo)
    tri_c = slot_tri & (cand_fd > r_lo) & (cand_fd <= r_hi)  # region pairs
    total, cnt_below, cnt_rtri = ring.all_reduce(
        mesh, torch.stack([pruned + slot_tri.sum(), below_m.sum(), tri_c.sum()]))
    sum_below = ring.all_reduce(mesh, torch.where(below_m, cand_fd, 0.0).sum())
    rmax, gmax = ring.all_reduce(mesh, torch.stack([rmax, gmax]), "max")
    rsum = ring.all_reduce(mesh, rsum)
    sup_any = bound_ctx["sup_ovf"] if cap > 0 else torch.zeros((), dtype=torch.bool, device=dev)
    ovf, sup_any = ring.all_reduce(mesh, torch.stack([ovf, sup_any]), "max")
    k = torch.round(rho32 * total.float()).long().clamp_min(1)
    kth_in = (cnt_below < k) & (k <= cnt_below + cnt_rtri)
    p_fast = kth_in & ~ovf & ~sup_any
    # Region pairs compact once more before the eps histograms; a slot-row
    # with more of them than ecap (exact count) sends eps alone to the
    # exact two-sweep form, the adjacency fast path is unaffected.
    ecap = _default_eps_cap(g_rows, gcap) if eps_cap is None else min(int(eps_cap), width)
    reg_ovf = ring.all_reduce(mesh, (tri_c.sum(1) > ecap).any(), "max")

    def eps_fast():
        """Closed-form eps from the compacted region only: a two-level
        histogram over (r_lo, r_hi], whose level-2 bins are sub-ulp."""
        rvals, _ = exact_min_k(torch.where(tri_c, cand_fd, float("inf")), ecap)
        rlive = torch.isfinite(rvals)
        rv = torch.where(rlive, rvals, r_lo)  # finite everywhere; dead slots are masked
        w_a = (r_hi - r_lo) / _BINS
        i_a = _to_bin((rv - r_lo) / w_a, _BINS)
        flat_a = torch.where(rlive, i_a, _BINS)
        hist_a = ring.all_reduce(mesh, _hist(flat_a, _BINS))
        sum_a = ring.all_reduce(mesh, _bin_sums(flat_a, torch.where(rlive, rvals, 0.0), _BINS))
        cum_a = cnt_below + torch.cumsum(hist_a, 0)
        bin_a = torch.searchsorted(cum_a, k).clamp_max(_BINS - 1)
        lo_b = r_lo + bin_a.float() * w_a
        w_b = w_a / _BINS
        in_a = rlive & (i_a == bin_a)
        i_b = _to_bin((rv - lo_b) / w_b, _BINS)
        flat_b = torch.where(in_a, i_b, _BINS)
        hist_b = ring.all_reduce(mesh, _hist(flat_b, _BINS))
        sum_b = ring.all_reduce(mesh, _bin_sums(flat_b, torch.where(in_a, rvals, 0.0), _BINS))
        min_b = ring.all_reduce(
            mesh, _bin_mins(flat_b, torch.where(in_a, rvals, float("inf")), _BINS), "min")
        below_a_cnt = _at(cum_a, bin_a, cnt_below)
        cum_b = below_a_cnt + torch.cumsum(hist_b, 0)
        bin_b = torch.searchsorted(cum_b, k).clamp_max(_BINS - 1)
        below_cnt = _at(cum_b, bin_b, below_a_cnt)
        below_sum = (sum_below + _at(torch.cumsum(sum_a, 0), bin_a, 0.0)
                     + _at(torch.cumsum(sum_b, 0), bin_b, 0.0))
        kth = min_b[bin_b]
        return (below_sum + (k - below_cnt).float() * kth) / k.float()

    def eps_slow():
        """The sample misled or a capacity overflowed: exact two-sweep eps (a
        coarse histogram sweep locates the k-th bin, a fine sweep resolves
        it). k comes from this sweep's exact total: an overflow drops live
        slots, so the slot total may undercount the nonzero pairs."""
        hist0 = torch.zeros(_BINS, dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            fd = final_chunk(c)
            tri = chunk_valid(c) & (fd != 0.0)
            hist0 += _hist(torch.where(tri, cidx(fd), _BINS), _BINS)
        hist0 = ring.all_reduce(mesh, hist0)
        k = torch.round(rho32 * hist0.sum().float()).long().clamp_min(1)
        cum0 = torch.cumsum(hist0, 0)
        bin0 = torch.searchsorted(cum0, k).clamp_max(_BINS - 1)
        lo1 = bin0.float() * w0
        w1 = w0 / _BINS
        cnt_lo, sum_lo = zero, torch.zeros((), device=dev)
        fhist = torch.zeros(_BINS, dtype=torch.int64, device=dev)
        fsum = torch.zeros(_BINS, device=dev)
        fmin = torch.full((_BINS,), float("inf"), device=dev)
        for c in range(n_chunks):
            fd = final_chunk(c)
            tri = chunk_valid(c) & (fd != 0.0)
            ci = cidx(fd)
            below = tri & (ci < bin0)
            cnt_lo = cnt_lo + below.sum()
            sum_lo = sum_lo + torch.where(below, fd, 0.0).sum()
            inbin = tri & (ci == bin0)
            flat = torch.where(inbin, _to_bin((fd - lo1) / w1, _BINS), _BINS)
            fhist += _hist(flat, _BINS)
            fsum += _bin_sums(flat, torch.where(inbin, fd, 0.0), _BINS)
            fmin = torch.minimum(fmin, _bin_mins(flat, torch.where(inbin, fd, float("inf")),
                                                 _BINS))
        cnt_lo, fhist = ring.all_reduce(mesh, cnt_lo), ring.all_reduce(mesh, fhist)
        sum_lo, fsum = ring.all_reduce(mesh, sum_lo), ring.all_reduce(mesh, fsum)
        fmin = ring.all_reduce(mesh, fmin, "min")
        cum1 = cnt_lo + torch.cumsum(fhist, 0)
        bin1 = torch.searchsorted(cum1, k).clamp_max(_BINS - 1)
        below_cnt = _at(cum1, bin1, cnt_lo)
        below_sum = sum_lo + _at(torch.cumsum(fsum, 0), bin1, 0.0)
        kth = fmin[bin1]
        return (below_sum + (k - below_cnt).float() * kth) / k.float()

    fast, region_ovf = (bool(x) for x in torch.stack([p_fast, reg_ovf]).tolist())
    phase_end("main_sweep")
    eps = eps_fast() if fast and not region_ovf else eps_slow()
    phase_end("eps")

    # ---- phase 4: bit-packed adjacency -----------------------------------
    # The definite/band split is valid only when eps landed inside the
    # region; otherwise one sweep rebuilds the adjacency.
    eps_in = (eps >= r_lo) & (eps <= r_hi)
    # fallback_code: 1 a slot-group overflowed gcap, 2 the k-th pair lies
    # outside the sampled region, 4 eps outside the region, 8 a V row's
    # support overflowed the compaction width, 16 a slot-row's region pairs
    # overflowed eps_cap (eps took the two-sweep form; the adjacency fast
    # path is unaffected).
    code_bits = torch.stack([ovf, ~kth_in, ~eps_in, sup_any, reg_ovf]).tolist()
    fb_code = sum(w for w, bit in zip((1, 2, 4, 8, 16), code_bits) if bit)
    adj_ok = fast and not code_bits[2]
    nbytes = npad // 8
    if adj_ok:
        # Every adjacency pair has fd <= eps <= r_hi, so it is a compacted
        # candidate (both triangles, the diagonal included). A (row, col)
        # is in at most one slot, so adding distinct bits is their union;
        # the adds run in int32, the bytes are narrowed after.
        sel = live & (cand_fd <= eps)
        byte = torch.where(sel, cand_col // 8, nbytes)  # column nbytes: dropped
        bit = torch.where(sel, 1 << (cand_col & 7), 0).to(torch.int32)
        acc = torch.zeros(r * (nbytes + 1), dtype=torch.int32, device=dev)
        acc.scatter_add_(0, (rows_loc * (nbytes + 1) + byte).reshape(-1), bit.reshape(-1))
        adj_p = acc.view(r, nbytes + 1)[:, :nbytes].to(torch.uint8)
        del acc
    else:
        adj_p = torch.empty((r, nbytes), dtype=torch.uint8, device=dev)
        for c in range(n_chunks):
            rows = torch.arange(row0 + c * b, row0 + (c + 1) * b, device=dev)
            ok = (rows[:, None] < n) & col_valid[None, :]
            adj_p[c * b:(c + 1) * b] = pack_bits((final_chunk(c) <= eps) & ok)
    # Symmetrise: OR on packed bytes is set union.
    adj_p = adj_p | stripe_transpose_packed(adj_p, mesh)

    big = npad
    degree = torch.empty(r, dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        degree[c * b:(c + 1) * b] = popcount(adj_p[c * b:(c + 1) * b]).sum(1)
    core_local = degree >= min_samples
    core = ring.all_gather(mesh, core_local)
    phase_end("adjacency")
    core_p = pack_bits(core)  # column mask, packed
    idx = torch.arange(npad, device=dev)
    gidx = idx[row0:row0 + r]
    adj_core_p = torch.where(core_local[:, None], adj_p & core_p[None, :], 0)
    labels = ring.all_gather(mesh, torch.where(core_local, gidx, big))

    def neighbour_min(adj, labels):
        """Each stripe row's least label over its packed adjacency, a chunk
        of rows unpacked at a time."""
        out = torch.empty(r, dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            a = unpack_bits(adj[c * b:(c + 1) * b], npad)
            out[c * b:(c + 1) * b] = torch.where(a, labels[None, :], big).amin(1)
        return out

    # Min-label propagation to the fixed point (a host read a round), with
    # one pointer jump a round: lab[i] <- min(lab[i], lab[lab[i]]). A label
    # is always the index of a smaller core point of the same component, so
    # the fixed point, the component minimum, is unchanged by the jump.
    rounds = 0
    while True:
        new = ring.all_gather(mesh, torch.minimum(labels[gidx], neighbour_min(adj_core_p, labels)))
        hop = torch.where(new < big, new, 0)
        new = torch.where(new < big, torch.minimum(new, new[hop]), new)
        rounds += 1
        done = torch.equal(new, labels)
        labels = new
        if done:
            break

    core_neigh = ring.all_gather(mesh, neighbour_min(adj_p & core_p[None, :], labels))
    raw = torch.where(core, labels, core_neigh)
    is_root = core & (labels == idx)
    root_rank = torch.cumsum(is_root.long(), 0) - 1
    out = torch.where(raw < big, root_rank[torch.where(raw < big, raw, 0)], -1)
    diag_vec = torch.stack([r_lo, r_hi, e_lo, e_hi, cnt_rtri.float(), rmax.float(),
                            rsum.float(), gmax.float(),
                            torch.tensor(float(rounds), device=dev)]).cpu().numpy()
    phase_end("dbscan")
    return (out[:n].to(torch.int32), int(is_root.sum()), float(eps), not adj_ok, fb_code,
            diag_vec, None if final is None else final[:n, :n], seconds)


def _stripe_config(features, chunk, col_blocks, dev, p: int = 1):
    """Row padding, column blocking and the chunk over ``p`` ranks. Returns
    (f, n, npad, n_vblk, c), ``f`` fp32 on ``dev`` with a leading group axis
    kept.

    Rows pad to a multiple of lcm(p chunk, 8 p), as JAX's (each rank's
    stripe r = npad / p a multiple of 8 for the packed adjacency bytes),
    and the chunk divides r. ``col_blocks`` stores V and rh as that many
    column blocks; the default is 1, since a PyTorch buffer has no size
    limit (XLA's 2 GiB limit makes the JAX package pick more above 1 GiB).
    Every consumer decomposes additively over the blocks.
    """
    f = torch.as_tensor(features, device=dev).float()
    n = f.shape[-2]
    base = p * chunk if n > p * chunk else p
    mult = math.lcm(base, 8 * p)
    npad = _round_up(n, mult)
    if npad > n:
        pad = torch.zeros((*f.shape[:-2], npad - n, f.shape[-1]), device=dev)
        f = torch.cat([f, pad], -2)
    n_vblk = 1 if col_blocks is None else int(col_blocks)
    if npad % n_vblk:
        raise ValueError(f"col_blocks {n_vblk} must divide {npad}")
    r = npad // p
    c = min(chunk, r)
    while r % c:
        c -= 1
    return f, n, npad, n_vblk, c


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _mesh_device(mesh, device):
    return resolve_device(device) if mesh is None else mesh.device


def _default_band_cap(npad: int) -> int:
    """Candidates a row: ~0.017 N measured at most on real features with the
    one-directional bound; 2x headroom, 64-aligned."""
    return max(256, _round_up(npad // 30, 64))


def _fill_diag(diag: dict, band_fallback: bool, fb_code: int, dv) -> None:
    diag["band_fallback"] = band_fallback
    diag["fallback_code"] = fb_code
    diag["r_lo"], diag["r_hi"] = float(dv[0]), float(dv[1])
    diag["e_lo"], diag["e_hi"] = float(dv[2]), float(dv[3])
    diag["region_tri_pairs"] = int(dv[4])
    diag["cand_row_max"] = int(dv[5])
    diag["cand_total"] = int(dv[6])
    diag["cand_group_max"] = int(dv[7])
    diag["dbscan_rounds"] = int(dv[8])


def streaming_cluster(features, k1: int = 20, k2: int = 6, lambda_value: float = 0.1,
                      rho: float = 1.6e-3, min_samples: int = 4, chunk: int = 512,
                      l1_impl: str = "auto", col_blocks: int | None = None,
                      return_final: bool = False, band_cap: int | None = None,
                      support_cap: int = 128, eps_cap: int | None = None,
                      diag: dict | None = None, device=None, mesh=None):
    """k-reciprocal re-ranking + auto-eps DBSCAN without the (N, N) distance
    matrices: one fp32 V and packed / bf16 state, distance rows recomputed
    chunk by chunk from ``features`` (N, D). With ``mesh`` (``make_mesh``)
    the state is row-sharded over its ranks, each holding ``features``
    alike; the call is collective and every rank returns the same result.

    Returns (labels (N,) np.int32, n_clusters, eps), equal to ``api.cluster``
    of ``api.re_ranking`` (eps to fp32 histogram exactness). With
    ``return_final=True`` (debugging: it builds the dense (N, N) re-ranked
    matrix) a fourth element, that matrix, is appended.

    ``band_cap`` is the capacity a row for candidate pairs the screening
    bound cannot prune (fd_lb <= r_hi); overflow takes the exact but slower
    fallback sweeps, with the same labels. The default grows with N (the
    eps quantile is a fixed fraction rho of the N^2 pairs); ``band_cap=0``
    always takes the fallback. ``support_cap`` is the compacted V row width
    (V rows with more nonzeros take the fallback too). ``eps_cap`` bounds
    the second compaction of the region pairs; its overflow sends eps alone
    to the two-sweep form. ``l1_impl`` is ``ops.l1.l1_distance``'s (the
    fallback sweeps and the phase-3 sample run the L1 kernel on the card).
    ``diag`` (a dict) receives ``band_fallback``, ``fallback_code`` (bits 1,
    2, 4, 8, 16; see ``_cluster_one``), the region edges, the candidate
    counts, the DBSCAN rounds and ``seconds``, each phase's host-clock time
    (the device is synchronised at each phase's end only when ``diag`` is
    given). Runs on the card unless ``device="cpu"`` (with a mesh, on the
    mesh's device).
    """
    dev = _mesh_device(mesh, device)
    f, n, npad, n_vblk, c = _stripe_config(features, chunk, col_blocks, dev, _size(mesh))
    band_cap = _default_band_cap(npad) if band_cap is None else int(band_cap)
    labels, n_clusters, eps, band_fallback, fb_code, dv, final, secs = _cluster_one(
        f, n, float(rho), min(int(k1), n - 1), min(int(k2), n - 1), float(lambda_value),
        int(min_samples), c, l1_impl, n_vblk, return_final, band_cap, int(support_cap), eps_cap,
        timed=diag is not None, mesh=mesh)
    if diag is not None:
        _fill_diag(diag, band_fallback, fb_code, dv)
        diag["seconds"] = secs
    labels = labels.cpu().numpy()
    if return_final:
        return labels, n_clusters, eps, final
    return labels, n_clusters, eps


def streaming_cluster_groups(features, k1: int = 20, k2: int = 6, lambda_value: float = 0.1,
                             rho: float = 1.6e-3, min_samples: int = 4, chunk: int = 512,
                             l1_impl: str = "auto", col_blocks: int | None = None,
                             band_cap: int | None = None, support_cap: int = 128,
                             eps_cap: int | None = None, diag: dict | None = None,
                             device=None, mesh=None):
    """``streaming_cluster`` for every feature group of ``features`` (G, N,
    D) (or a list of (N, D)), the SSG whole / upper / lower embeddings. Each
    group's result equals a separate ``streaming_cluster`` call.

    Returns (labels (G, N) np.int32, counts list[int], eps list[float]).
    ``diag`` (a dict) receives per-group lists ``band_fallback``,
    ``fallback_code`` and ``seconds`` and the (G, 9) array ``diag_vec``.
    ``mesh`` as ``streaming_cluster``'s.
    """
    dev = _mesh_device(mesh, device)
    if isinstance(features, (list, tuple)):
        features = torch.stack([torch.as_tensor(x, device=dev) for x in features])
    f, n, npad, n_vblk, c = _stripe_config(features, chunk, col_blocks, dev, _size(mesh))
    band_cap = _default_band_cap(npad) if band_cap is None else int(band_cap)
    outs = [_cluster_one(fg, n, float(rho), min(int(k1), n - 1), min(int(k2), n - 1),
                         float(lambda_value), int(min_samples), c, l1_impl, n_vblk, False,
                         band_cap, int(support_cap), eps_cap, timed=diag is not None, mesh=mesh)
            for fg in f]
    if diag is not None:
        diag["band_fallback"] = [o[3] for o in outs]
        diag["fallback_code"] = [o[4] for o in outs]
        diag["diag_vec"] = np.stack([o[5] for o in outs])
        diag["seconds"] = [o[7] for o in outs]
    return (torch.stack([o[0] for o in outs]).cpu().numpy(), [o[1] for o in outs],
            [o[2] for o in outs])


def streaming_rerank_eval(query_features, gallery_features, q_ids, g_ids, q_cams, g_cams,
                          k1: int = 20, k2: int = 6, lambda_value: float = 0.1,
                          chunk: int = 512, l1_impl: str = "auto",
                          col_blocks: int | None = None, diag: dict | None = None,
                          device=None, mesh=None):
    """Test-time k-reciprocal re-ranked evaluation without the (N, N)
    re-ranked matrix or its (Q, G) block, market1501 protocol.

    Phases 1-2 build V as ``streaming_cluster`` does over the query and
    gallery rows; then one sweep over the query rows reduces each chunk of
    re-ranked rows to additive CMC / mAP statistics (``rank_stats_hits``;
    a chunk with a query of more than 64 relevant columns is redone with
    the argsort form after the sweep). Equal to ``api.evaluate_all`` of the
    dense ``re_ranking(concat(qf, gf))[:Q, Q:]`` up to summation order.

    Layout, JAX's: each rank's stripe holds ceil(Q / P) query rows first,
    then its ceil(G / P) gallery rows, so the sweep visits only
    ceil(ceil(Q / P) / chunk) chunks of each stripe (the same count on
    every rank, whose ring collectives must stay aligned). On one device
    that is the queries, then the gallery.

    Returns (mAP, cmc (100,) np array, n_valid_queries), the same on every
    rank of ``mesh``. ``diag`` (a dict) receives ``final_rows``, this
    rank's first query chunk's re-ranked distances to the gallery columns
    (the rows the sweep ranked), to hold against the dense matrix.
    """
    dev = _mesh_device(mesh, device)
    p, me = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    qf = torch.as_tensor(query_features, device=dev).float()
    gf = torch.as_tensor(gallery_features, device=dev).float()
    nq, ng = qf.shape[0], gf.shape[0]
    n = nq + ng
    qr, gr = -(-nq // p), -(-ng // p)  # query / gallery slots a rank
    base = p * chunk if n > p * chunk else p
    npad = _round_up(p * (qr + gr), math.lcm(base, 8 * p))
    r = npad // p
    c = min(chunk, r)
    while r % c:
        c -= 1
    n_vblk = 1 if col_blocks is None else int(col_blocks)
    if npad % n_vblk:
        raise ValueError(f"col_blocks {n_vblk} must divide {npad}")

    # src[i]: the row of concat(qf, gf) at layout slot i (-1: padding).
    src = np.full(npad, -1, np.int64)
    is_q = np.zeros(npad, bool)
    for k in range(p):
        q0, q1 = k * qr, min((k + 1) * qr, nq)
        if q1 > q0:
            src[k * r:k * r + q1 - q0] = np.arange(q0, q1)
            is_q[k * r:k * r + q1 - q0] = True
        g0, g1 = k * gr, min((k + 1) * gr, ng)
        if g1 > g0:
            src[k * r + qr:k * r + qr + g1 - g0] = nq + np.arange(g0, g1)
    live = src >= 0
    ids_all = np.concatenate([np.asarray(q_ids, np.int64), np.asarray(g_ids, np.int64)])
    cams_all = np.concatenate([np.asarray(q_cams, np.int64), np.asarray(g_cams, np.int64)])

    def slot(x):
        return torch.as_tensor(np.where(live, x[np.where(live, src, 0)], 0), device=dev)

    valid = torch.as_tensor(live, device=dev)
    row_qmask = torch.as_tensor(is_q, device=dev)
    col_gmask = valid & ~row_qmask
    ids, cams = slot(ids_all), slot(cams_all)
    allf = torch.cat([qf, gf, qf.new_zeros((1, qf.shape[1]))])
    f = allf[torch.as_tensor(np.where(live, src, n), device=dev)]

    final_chunk, _, _, _, _, row0, _ = _phases12(
        f, n, min(int(k1), n - 1), min(int(k2), n - 1), float(lambda_value), c, n_vblk,
        l1_impl, valid=valid, mesh=mesh)

    def stats(ch, fn):
        rows = slice(row0 + ch * c, row0 + (ch + 1) * c)
        fd = final_chunk(ch)
        if ch == 0 and diag is not None:
            diag["final_rows"] = fd[:min(c, qr), col_gmask]
        return fn(fd, ids[rows], ids, cams[rows], cams, row_qmask[rows], col_gmask)

    ap = torch.zeros((), device=dev)
    cmc = torch.zeros(100, device=dev)
    nv = torch.zeros((), dtype=torch.int64, device=dev)
    ovfs = []
    for ch in range(-(-qr // c)):
        a, cm, v, o = stats(ch, rank_stats_hits)
        ap = ap + torch.where(o, 0.0, a)
        cmc = cmc + torch.where(o, 0.0, cm)
        nv = nv + torch.where(o, 0, v)
        ovfs.append(o)
    # A chunk is redone on every rank where any rank overflowed (its ring
    # collectives must stay aligned); a rank adds it only where it did.
    mine = torch.stack(ovfs)
    for ch in torch.nonzero(ring.all_reduce(mesh, mine, "max")).flatten().tolist():
        a, cm, v = stats(ch, rank_stats_masked)
        if mine[ch]:
            ap, cmc, nv = ap + a, cmc + cm, nv + v
    ap, cmc, nv = ring.all_reduce(mesh, ap), ring.all_reduce(mesh, cmc), ring.all_reduce(mesh, nv)
    denom = max(int(nv), 1)
    return float(ap) / denom, cmc.cpu().numpy() / denom, int(nv)
