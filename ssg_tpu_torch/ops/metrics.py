"""CMC / mAP on the device, market1501 protocol.

Counterpart of ``ssg_tpu/ops/metrics.py`` (``rank_stats_masked``,
``rank_stats``, ``evaluate_rank``): argsort once, then masked cumulative
sums instead of per-query Python. Same-pid-same-cam gallery entries are
filtered per query; CMC with first_match_break. The sort is stable, as
``jnp.argsort`` is (``torch.argsort`` is not by default), so tied
distances rank in gallery order on both sides: CMC is bit-exact and AP
differs only by summation-order ulps. The sort-free ``rank_stats_hits`` /
``rank_stats_auto`` rank only each query's relevant columns, by masked
counts, for the streaming evaluator (``parallel/streaming.py``).

NaN distances rank last in both forms, as the stable argsort puts them. The
JAX package's compare-count form ranks a NaN hit first (every comparison
with NaN is false there); the port does not copy that.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.ops.topk import exact_min_k


def sorted_masks(distmat: torch.Tensor, query_ids: torch.Tensor, gallery_ids: torch.Tensor,
                 query_cams: torch.Tensor, gallery_cams: torch.Tensor,
                 col_mask: torch.Tensor | None = None, separate_camera_set: bool = False):
    """Each query's gallery in ascending distance and its masks, (Q, G)
    each: ``(order, matches, valid)``. ``valid`` leaves out the entries of
    the query's own identity and camera (open-reid rule), with
    ``separate_camera_set`` every entry of its camera, and the columns
    where ``col_mask`` is False."""
    order = torch.argsort(distmat, dim=1, stable=True)
    g_ids = gallery_ids[order]
    g_cams = gallery_cams[order]
    matches = g_ids == query_ids[:, None]
    valid = (g_ids != query_ids[:, None]) | (g_cams != query_cams[:, None])
    if separate_camera_set:
        valid &= g_cams != query_cams[:, None]
    if col_mask is not None:
        valid &= col_mask[order]
    return order, matches, valid


def rank_stats_masked(distmat: torch.Tensor, query_ids: torch.Tensor, gallery_ids: torch.Tensor,
                      query_cams: torch.Tensor, gallery_cams: torch.Tensor,
                      row_mask: torch.Tensor | None = None,
                      col_mask: torch.Tensor | None = None,
                      separate_camera_set: bool = False, pad: int = 100):
    """(ap_sum, cmc_sum (pad,), n_valid) over the rows of ``distmat`` (Q, G).

    Rows where ``row_mask`` is False contribute nothing; columns where
    ``col_mask`` is False are left out of every row's valid sublist, as the
    protocol's junk filtering leaves entries out. ``separate_camera_set``
    and ``pad`` (the curve's length) serve ``evaluation_metrics.cmc``.
    """
    _, matches, valid = sorted_masks(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                                     col_mask, separate_camera_set)
    rel = matches & valid

    # Rank of each gallery position within the valid sublist (1-indexed).
    rank_in_valid = torch.cumsum(valid.float(), 1)

    # AP: mean over hits of precision-at-hit.
    cum_rel = torch.cumsum(rel.float(), 1)
    prec_at = torch.where(rel, cum_rel / rank_in_valid.clamp_min(1.0), 0.0)
    num_rel = rel.sum(1)
    has_match = num_rel > 0
    if row_mask is not None:
        has_match = has_match & row_mask
    ap = prec_at.sum(1) / num_rel.clamp_min(1).float()
    ap_sum = torch.where(has_match, ap, 0.0).sum()

    # CMC (first_match_break): rank of the first hit in the valid sublist.
    big = float(distmat.shape[1] + 1)
    first_hit = torch.where(rel, rank_in_valid, big).amin(1)  # 1-indexed
    ks = torch.arange(1, pad + 1, dtype=torch.float32, device=distmat.device)
    hits = (first_hit[:, None] <= ks[None, :]) & has_match[:, None]
    cmc_sum = hits.float().sum(0)
    return ap_sum, cmc_sum, has_match.sum()


def rank_stats(distmat, query_ids, gallery_ids, query_cams, gallery_cams):
    """Per-query-chunk sufficient statistics (ap_sum, cmc_hit_sum (100,),
    n_valid_queries); chunks over the query axis combine by addition."""
    return rank_stats_masked(distmat, query_ids, gallery_ids, query_cams, gallery_cams)


def _ranks_before(distmat: torch.Tensor, dnan: torch.Tensor, col: torch.Tensor,
                  vb: torch.Tensor, jb: torch.Tensor) -> torch.Tensor:
    """(b, hb, G) bool: column j comes before hit (vb, jb) in the stable
    ascending order with NaN last: d_j < v_h, or d_j ties v_h (two NaNs
    tie) and j < h."""
    d = distmat[:, None, :]
    v = vb[:, :, None]
    vnan = torch.isnan(v)
    dn = dnan[:, None, :]
    lt = (d < v) | (vnan & ~dn)
    eq = (d == v) | (vnan & dn)
    return lt | (eq & (col[None, None, :] < jb[:, :, None]))


def rank_stats_hits(distmat: torch.Tensor, query_ids: torch.Tensor, gallery_ids: torch.Tensor,
                    query_cams: torch.Tensor, gallery_cams: torch.Tensor,
                    row_mask: torch.Tensor | None = None,
                    col_mask: torch.Tensor | None = None,
                    hit_cap: int = 64, hblock: int = 8):
    """Sort-free ``rank_stats_masked``: compare-count ranks of the hits.

    The statistics need only each relevant column's rank in the valid
    sublist, and that is a masked count, not a sort:

        rank(h) = #{j valid : j comes before h} + 1

    with "before" as the stable argsort orders (ties by column, NaN last).
    The <= ``hit_cap`` relevant columns of each row are compacted by column
    index (one ``exact_min_k`` over a rel-masked iota, so no distance value
    is ever a sentinel), then each block of ``hblock`` hits is one
    (rows, hblock, G) compare-count.

    Returns (ap_sum, cmc_sum (100,), n_valid, overflow), all tensors; no
    host read. ``overflow`` is True when an unmasked row has more than
    ``hit_cap`` relevant columns: the compaction dropped hits, and the
    caller must take the argsort form (``rank_stats_auto``). Otherwise CMC
    counts and n_valid equal ``rank_stats_masked``'s exactly, and AP differs
    only in the order of the row sum's additions.
    """
    b, g = distmat.shape
    dev = distmat.device
    matches = gallery_ids[None, :] == query_ids[:, None]
    valid = ((gallery_ids[None, :] != query_ids[:, None])
             | (gallery_cams[None, :] != query_cams[:, None]))
    if col_mask is not None:
        valid = valid & col_mask[None, :]
    rel = matches & valid
    num_rel = rel.sum(1)
    live = num_rel > 0
    if row_mask is not None:
        live = live & row_mask
    h = min(int(hit_cap), g)
    overflow = (torch.where(live, num_rel, 0) > h).any()

    col = torch.arange(g, device=dev)
    _, jh = exact_min_k(torch.where(rel, col.float(), float("inf")), h)
    vh = torch.gather(distmat, 1, jh)  # (b, h) hit distances
    # Slots past a row's count hold arbitrary in-range columns: masked out.
    relh = torch.arange(h, device=dev)[None, :] < num_rel[:, None]
    dnan = torch.isnan(distmat)
    rank = torch.empty((b, h), dtype=torch.float32, device=dev)
    crel = torch.empty((b, h), dtype=torch.float32, device=dev)
    hb = max(min(int(hblock), h), 1)
    for s in range(0, h, hb):
        cmp = _ranks_before(distmat, dnan, col, vh[:, s:s + hb], jh[:, s:s + hb])
        rank[:, s:s + hb] = (cmp & valid[:, None, :]).sum(2) + 1
        crel[:, s:s + hb] = (cmp & rel[:, None, :]).sum(2) + 1

    ap = torch.where(relh, crel / rank, 0.0).sum(1) / num_rel.clamp_min(1)
    ap_sum = torch.where(live, ap, 0.0).sum()
    first_hit = torch.where(relh, rank, float(g + 1)).amin(1)
    ks = torch.arange(1, 101, dtype=torch.float32, device=dev)
    hits = (first_hit[:, None] <= ks[None, :]) & live[:, None]
    return ap_sum, hits.float().sum(0), live.sum(), overflow


def rank_stats_auto(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                    row_mask=None, col_mask=None, hit_cap: int = 64):
    """``rank_stats_hits`` with the exact argsort form when a row has more
    than ``hit_cap`` hits (one host read of the overflow flag). Equals
    ``rank_stats_masked`` on every input: CMC and n_valid exactly, AP to the
    order of its additions. The JAX package's API; the port's streaming
    evaluator takes the same fallback but defers it past its sweep (one host
    read for all chunks), so it calls the two forms itself."""
    a, cm, v, ovf = rank_stats_hits(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                                    row_mask, col_mask, hit_cap=hit_cap)
    if bool(ovf):
        return rank_stats_masked(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                                 row_mask, col_mask)
    return a, cm, v


def evaluate_rank(distmat, query_ids, gallery_ids, query_cams,
                  gallery_cams) -> dict[str, torch.Tensor]:
    """Returns {'mAP': scalar, 'cmc': (100,) curve}, market1501 protocol.

    CMC/AP are computed over each query's valid gallery sublist (entries
    sharing both pid and cam with the query are excluded, open-reid rule);
    queries with no valid match are dropped from both averages.
    """
    ap_sum, cmc_sum, n_valid = rank_stats(distmat, query_ids, gallery_ids, query_cams,
                                          gallery_cams)
    n = n_valid.clamp_min(1).float()
    return {"mAP": ap_sum / n, "cmc": cmc_sum / n}
