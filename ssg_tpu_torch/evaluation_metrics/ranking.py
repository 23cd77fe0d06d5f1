"""CMC / mAP with the reference's full flag surface, computed on the device.

Counterpart of ``ssg_tpu/evaluation_metrics/ranking.py``, which mirrors
[reid/evaluation_metrics/ranking.py] (SURVEY.md §2 #8): ``cmc(...,
separate_camera_set, single_gallery_shot, first_match_break, topk)`` and
``mean_ap(...)``. One stable ``torch.argsort`` of every query's row
(``ops.metrics.sorted_masks``), then masked cumulative sums for all queries
at once (first_match_break and mAP: ``ops.metrics.rank_stats_masked``, the
evaluator's), a scatter-add histogram (allshots), or, for the randomised cuhk03
``single_gallery_shot`` protocol, a per-identity sample by group-argmin
over random priorities, 10 repeats. The sort is stable, as
``jnp.argsort`` is, so tied distances rank in gallery order on both sides.

Inputs are tensors or numpy arrays; they are moved to ``device`` (the card
unless ``"cpu"``, ``_device.py``) and the results come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.ops.metrics import rank_stats, rank_stats_masked, sorted_masks

_TOPK_PAD = 100  # the curve is computed to a multiple of this, then sliced
_REPEATS = 10  # single_gallery_shot draws


def _allshots_curve(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                    separate_camera_set: bool, pad: int):
    """Allshots: the j-th hit of a query lands in bin (rank - 1) - (j - 1)
    with weight 1 / num_rel; an fp32 histogram by scatter-add, then cumsum.
    Returns the curve's sum over queries and the count of valid queries."""
    _, matches, valid = sorted_masks(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                                     separate_camera_set=separate_camera_set)
    rel = matches & valid
    bins = (torch.cumsum(valid.float(), 1) - torch.cumsum(rel.float(), 1)).long()
    bins = torch.where(rel & (bins < pad), bins, pad)
    num_rel = rel.sum(1)
    w = torch.where(rel, 1.0 / num_rel.clamp_min(1)[:, None], 0.0)
    hist = torch.zeros(pad + 1, dtype=torch.float32, device=distmat.device)
    hist.index_add_(0, bins.reshape(-1), w.reshape(-1))
    return torch.cumsum(hist[:pad], 0), (num_rel > 0).sum()


def _cmc_single_gallery_shot(distmat, query_ids, gallery_ids, query_cams, gallery_cams,
                             gallery_codes, generator: torch.Generator,
                             separate_camera_set: bool, pad: int):
    """cuhk03 single-gallery-shot protocol on the device.

    Per repeat: one valid gallery instance per gallery identity, uniform
    within the identity (the least of iid random priorities, ties broken by
    sorted position through a second group-min), then the rank of the one
    sampled match within the sampled subsequence. Returns the mean of the
    repeats' curves summed over queries, and the count of valid queries."""
    q, g = distmat.shape
    order, matches, valid = sorted_masks(distmat, query_ids, gallery_ids, query_cams,
                                         gallery_cams, separate_camera_set=separate_camera_set)
    codes = gallery_codes[order]  # (Q, G) dense identity codes in sorted order
    has_match = (matches & valid).any(1)
    n_valid = has_match.sum()
    dev = distmat.device
    cols = torch.arange(g, device=dev).expand(q, g)
    big_u = torch.iinfo(torch.int64).max
    ks = torch.arange(1, pad + 1, dtype=torch.float32, device=dev)
    curves = []
    for _ in range(_REPEATS):
        u = torch.randint(0, 2**62, (q, g), generator=generator, device=dev)
        u = torch.where(valid, u, big_u)
        table_u = torch.full((q, g), big_u, device=dev).scatter_reduce_(1, codes, u, "amin")
        at_min = valid & (u == table_u.gather(1, codes))
        pos = torch.where(at_min, cols, g)
        table_p = torch.full((q, g), g, device=dev).scatter_reduce_(1, codes, pos, "amin")
        sampled = at_min & (cols == table_p.gather(1, codes))
        rank = torch.cumsum(sampled.float(), 1)
        first_hit = torch.where(matches & sampled, rank, float(g + 1)).amin(1)
        hits = (first_hit[:, None] <= ks[None, :]) & has_match[:, None]
        curves.append(hits.float().sum(0))
    return torch.stack(curves).mean(0), n_valid


def _on(device, distmat, *ids):
    """The inputs on ``device``: the distances in fp32, as the JAX package
    takes them (64-bit types off), the ids and cameras as they are."""
    return [torch.as_tensor(distmat, device=device).float()] + [
        torch.as_tensor(a, device=device) for a in ids]


def cmc(distmat, query_ids, gallery_ids, query_cams, gallery_cams, topk: int = 100,
        separate_camera_set: bool = False, single_gallery_shot: bool = False,
        first_match_break: bool = False, rng: np.random.Generator | None = None,
        device=None) -> np.ndarray:
    """CMC curve (length ``topk``, fp32, on the host). Reference defaults:
    allshots; the market1501 protocol is ``first_match_break=True``; cuhk03
    is ``separate_camera_set`` + ``single_gallery_shot`` (randomised: the
    priorities come from a ``torch.Generator`` seeded with
    ``rng.integers(2**31)``, ``rng`` defaulting to ``default_rng(0)``, as
    the JAX package seeds its key; the draws differ from JAX's). The
    reference oracle's quirk that ``single_gallery_shot`` with
    ``first_match_break`` adds a full 1 per repeat (the curve sums towards
    the repeat count, not 1) is kept. Any ``topk`` is accepted. Raises
    ``RuntimeError("No valid query")`` when no query has a valid match."""
    dev = resolve_device(device)
    d, q_ids, g_ids, q_cams, g_cams = _on(dev, distmat, query_ids, gallery_ids, query_cams,
                                          gallery_cams)
    pad = max(_TOPK_PAD, -(-int(topk) // _TOPK_PAD) * _TOPK_PAD)
    if single_gallery_shot:
        _, codes = torch.unique(g_ids, return_inverse=True)
        seed = int((rng or np.random.default_rng(0)).integers(2**31))
        generator = torch.Generator(device=dev).manual_seed(seed)
        curve, n_valid = _cmc_single_gallery_shot(d, q_ids, g_ids, q_cams, g_cams, codes,
                                                  generator, separate_camera_set, pad)
    elif first_match_break:
        _, curve, n_valid = rank_stats_masked(d, q_ids, g_ids, q_cams, g_cams,
                                              separate_camera_set=separate_camera_set, pad=pad)
    else:
        curve, n_valid = _allshots_curve(d, q_ids, g_ids, q_cams, g_cams, separate_camera_set,
                                         pad)
    if int(n_valid) == 0:
        raise RuntimeError("No valid query")
    curve = curve / n_valid.float()
    if single_gallery_shot and first_match_break:
        curve = curve * _REPEATS
    return curve[:topk].cpu().numpy()


def mean_ap(distmat, query_ids, gallery_ids, query_cams, gallery_cams, device=None) -> float:
    """mAP over valid queries (open-reid rule: same-pid-same-cam gallery
    entries excluded; queries with no remaining match dropped)."""
    dev = resolve_device(device)
    ap_sum, _, n_valid = rank_stats(*_on(dev, distmat, query_ids, gallery_ids, query_cams,
                                         gallery_cams))
    if int(n_valid) == 0:
        raise RuntimeError("No valid query")
    return float(ap_sum / n_valid)
