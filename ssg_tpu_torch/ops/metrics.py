"""CMC / mAP on the device, market1501 protocol.

Counterpart of ``ssg_tpu/ops/metrics.py`` (``rank_stats_masked``,
``rank_stats``, ``evaluate_rank``): argsort once, then masked cumulative
sums instead of per-query Python. Same-pid-same-cam gallery entries are
filtered per query; CMC with first_match_break. The sort is stable, as
``jnp.argsort`` is (``torch.argsort`` is not by default), so tied
distances rank in gallery order on both sides: CMC is bit-exact and AP
differs only by summation-order ulps. The sort-free ``rank_stats_hits`` /
``rank_stats_auto`` come with the streaming evaluator (ROADMAP A8).
"""

from __future__ import annotations

import torch


def rank_stats_masked(distmat: torch.Tensor, query_ids: torch.Tensor, gallery_ids: torch.Tensor,
                      query_cams: torch.Tensor, gallery_cams: torch.Tensor,
                      row_mask: torch.Tensor | None = None,
                      col_mask: torch.Tensor | None = None):
    """(ap_sum, cmc_sum (100,), n_valid) over the rows of ``distmat`` (Q, G).

    Rows where ``row_mask`` is False contribute nothing; columns where
    ``col_mask`` is False are left out of every row's valid sublist, as the
    protocol's junk filtering leaves entries out.
    """
    order = torch.argsort(distmat, dim=1, stable=True)  # ascending distance
    g_ids = gallery_ids[order]  # (Q, G)
    g_cams = gallery_cams[order]

    matches = g_ids == query_ids[:, None]
    valid = (g_ids != query_ids[:, None]) | (g_cams != query_cams[:, None])
    if col_mask is not None:
        valid = valid & col_mask[order]
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
    ks = torch.arange(1, 101, dtype=torch.float32, device=distmat.device)
    hits = (first_hit[:, None] <= ks[None, :]) & has_match[:, None]
    cmc_sum = hits.float().sum(0)
    return ap_sum, cmc_sum, has_match.sum()


def rank_stats(distmat, query_ids, gallery_ids, query_cams, gallery_cams):
    """Per-query-chunk sufficient statistics (ap_sum, cmc_hit_sum (100,),
    n_valid_queries); chunks over the query axis combine by addition."""
    return rank_stats_masked(distmat, query_ids, gallery_ids, query_cams, gallery_cams)


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
