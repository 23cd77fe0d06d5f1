"""Public API of the port: extract -> re-rank -> auto-eps DBSCAN, the
evaluator and the SSG loop.

Counterpart of ``ssg_tpu/api.py``: ``extract_features``, ``re_ranking``,
``cluster``, ``cluster_groups``, ``evaluate_all``, ``Evaluator`` and
``train`` (``train.ssg_loop.run_ssg``). Every entry point runs on the card
unless ``device="cpu"`` is given (``_device.py``). Hosts see uint8 batches
in and numpy labels and metrics out. A model is an ``nn.Module`` holding
its own weights, where the JAX package passes ``(model, variables)``.

``extract_features`` and ``cluster_groups`` open the spans of
``utils.profiling`` (the JAX package's ``named_scope`` per stage): one
``extract.batch`` a batch and ``extract.gather``; per group
``cluster.dist``, ``cluster.rerank``, ``cluster.eps`` and
``cluster.dbscan``, each with its stream time, then ``cluster.readback``.
"""

from __future__ import annotations

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cluster import dbscan, select_eps
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.metrics import rank_stats
from ssg_tpu_torch.ops.rerank import _re_ranking_impl, re_ranking
from ssg_tpu_torch.parallel import streaming_rerank_eval
from ssg_tpu_torch.parallel.dp import shard_batch
from ssg_tpu_torch.parallel.ring import all_gather
from ssg_tpu_torch.utils.profiling import span

__all__ = ["extract_features", "re_ranking", "cluster", "cluster_groups", "train",
           "pairwise_distance", "evaluate_all", "Evaluator"]

# Re-ranked evaluation streams (``parallel.streaming_rerank_eval``) once one
# fp32 (Q+G)^2 matrix would pass this many bytes, as the JAX package does.
DENSE_RERANK_BYTES = 2**30


@torch.no_grad()
def _forward_eval(model, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> (num_parts, B, F) L2-normalised embeddings."""
    return model(transforms.test_transform(images_u8))["embeddings"]


def extract_features(model, batches, device=None, mesh=None):
    """Part embeddings of every real row of ``batches``, in eval mode.

    ``batches`` iterates ``(images_u8, pids, cams, mask)`` (numpy or tensors;
    ``data.Preprocessor``'s contract); ``mask`` marks real rows, and padding
    rows are dropped. ``model`` must already be on ``device``; it runs in
    eval mode (as JAX's ``train=False``: a train-mode forward would update
    the BN statistics and return raw embeddings), and its mode is restored
    afterwards. Returns ``(features (num_parts, N, F) on device, pids, cams,
    fnames)``: ``fnames`` are ``batches.fnames`` (a ``Preprocessor``'s file
    names), or None for batches that name no files.

    ``mesh`` (``parallel.make_mesh``, the model alike on every rank): each
    rank forwards its slice of every batch (the batch must divide by the
    mesh's size) and the embeddings are all-gathered in batch order, so
    every rank returns the whole result, on the mesh's device.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    multi = mesh is not None and mesh.size > 1
    chunks, pids, cams, masks = [], [], [], []
    was_training = model.training
    model.eval()
    try:
        for b, (images, p, c, mask) in enumerate(batches):
            with span("extract.batch", key=b):
                if multi:
                    images = shard_batch(mesh, images)
                emb = _forward_eval(model, torch.as_tensor(images, device=dev))
                chunks.append(all_gather(mesh, emb.transpose(0, 1).contiguous()).transpose(0, 1)
                              if multi else emb)
                pids.append(np.asarray(p))
                cams.append(np.asarray(c))
                masks.append(np.asarray(mask, dtype=bool))
    finally:
        model.train(was_training)
    with span("extract.gather"):
        keep = np.concatenate(masks)
        feats = torch.cat(chunks, 1)[:, torch.as_tensor(np.flatnonzero(keep), device=dev)]
    names = getattr(batches, "fnames", None)
    fnames = None if names is None else [f for f, m in zip(names, keep) if m]
    return feats, np.concatenate(pids)[keep], np.concatenate(cams)[keep], fnames


def cluster(dist, eps: float | None = None, min_samples: int = 4,
            rho: float = 1.6e-3, device=None) -> tuple[np.ndarray, int, float]:
    """DBSCAN with SSG auto-eps. Returns (labels, num_clusters, eps);
    labels match sklearn exactly."""
    d = torch.as_tensor(dist, device=resolve_device(device))
    eps_val = select_eps(d, rho=rho) if eps is None else float(eps)
    labels, n = dbscan(d, eps_val, min_samples=min_samples)
    return labels.cpu().numpy(), int(n), float(eps_val)


def cluster_groups(feats, k1: int = 20, k2: int = 6, lambda_value: float = 0.1,
                   rho: float = 1.6e-3, min_samples: int = 4, l1_impl: str = "auto",
                   dist_impl: str = "auto", device=None):
    """The SSG per-iteration analytics block for every feature group.

    Args:
      feats: (num_parts, N, F) embeddings (tensor or numpy).
      l1_impl: ``"auto"`` (the CUDA L1 kernel on the card) or ``"torch"``
        (its plain version; the reference the kernel path is held against),
        or a JAX name, as ``ops.l1.l1_distance`` takes them.
      dist_impl: ``"auto"`` (the cuBLAS distance) or ``"kernel"`` (the CUDA
        distance kernel on the card), or a JAX name, as
        ``ops.distance.pairwise_distance`` takes them.

    Returns (labels (num_parts, N) np.int32, n_clusters list, eps list).
    """
    f = torch.as_tensor(feats, device=resolve_device(device))
    labels, counts, epss = [], [], []
    for g in range(f.shape[0]):
        with span("cluster.dist", key=g, device=True):
            original = pairwise_distance(f[g], squared=True, impl=dist_impl)
        with span("cluster.rerank", key=g, device=True):
            dist = _re_ranking_impl(original, int(k1), int(k2), float(lambda_value), l1_impl)
        with span("cluster.eps", key=g, device=True):
            eps_g = select_eps(dist, rho=rho)
        with span("cluster.dbscan", key=g, device=True):
            labels_g, n_g = dbscan(dist, eps_g, min_samples=int(min_samples))
        labels.append(labels_g)
        counts.append(n_g)
        epss.append(eps_g)
    with span("cluster.readback"):
        return (
            torch.stack(labels).cpu().numpy(),
            [int(c) for c in torch.stack(counts).cpu()],
            [float(e) for e in torch.stack(epss).cpu()],
        )


def evaluate_all(distmat, query, gallery, logger=None, query_chunk: int | None = None,
                 device=None):
    """CMC rank-1/5/10 + mAP with the market1501 protocol (SURVEY.md §3.5).

    ``query``/``gallery`` are (fname, pid, camid) triplet lists; ``distmat``
    (Q, G) is a tensor or a numpy array. ``query_chunk``: process queries
    in chunks of this size (chosen when the full (Q, G) argsort buffers
    would pass ~1 GiB, MSMT17-scale galleries), slicing the input, so a
    host matrix is never one device buffer.
    """
    dev = resolve_device(device)

    def ids(items, k):
        return torch.as_tensor(np.asarray([t[k] for t in items], dtype=np.int64), device=dev)

    q_ids, g_ids, q_cams, g_cams = ids(query, 1), ids(gallery, 1), ids(query, 2), ids(gallery, 2)
    nq, ng = distmat.shape
    if query_chunk is None:
        # Keep per-chunk (Qc, G) fp32/int buffers under ~1 GiB.
        query_chunk = nq if nq * ng * 4 <= 2**30 else max(2**30 // (ng * 4), 1)
    # Chunks over the query axis combine by addition (one chunk when dense).
    ap_sum, cmc_sum, n_valid = 0.0, 0.0, 0
    for s in range(0, nq, query_chunk):
        e = min(s + query_chunk, nq)
        a, c, v = rank_stats(torch.as_tensor(distmat[s:e], device=dev), q_ids[s:e], g_ids,
                             q_cams[s:e], g_cams)
        ap_sum += float(a)
        cmc_sum = cmc_sum + c.cpu().numpy()
        n_valid += int(v)
    n = max(n_valid, 1)
    return _report(ap_sum / n, cmc_sum / n, logger)


def _report(mAP, cmc, logger=None):
    print(f"Mean AP: {mAP:.1%}")
    print("CMC Scores")
    for k in (1, 5, 10):
        print(f"  top-{k:<4}{cmc[k - 1]:.1%}")
    if logger is not None:
        logger.metric(kind="eval", mAP=mAP, rank1=float(cmc[0]),
                      rank5=float(cmc[4]), rank10=float(cmc[9]))
    return {"mAP": mAP, "cmc": cmc}


class Evaluator:
    """Reference-shaped evaluator: extract query+gallery features, distance,
    metrics ([reid/evaluators.py] ``Evaluator.evaluate``, SURVEY.md §3.5).

    ``model`` is the module, holding its own weights; it is run in eval
    mode. ``part`` selects which embedding branch ranks the gallery:
    ``"concat"`` concatenates all branches and L2-normalises them (the SSG
    eval choice for multi-part models), or ``"whole"``, ``"up"``,
    ``"down"``.

    ``mesh``: extract over its ranks (the batch rounded up to a multiple of
    its size) and, with ``rerank=True``, always evaluate through the
    streaming re-ranked evaluator over the mesh, as JAX does; every rank
    returns the same metrics.
    """

    def __init__(self, model, batch_size: int = 64, part: str = "concat", device=None,
                 mesh=None):
        self.model = model
        if mesh is not None and batch_size % mesh.size:
            # Sharded extraction needs the (padded) batch to split evenly.
            batch_size = -(-batch_size // mesh.size) * mesh.size
        self.batch_size = batch_size
        self.part = part
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device

    def _feats(self, dataset, items):
        pre = Preprocessor(dataset, items=items, batch_size=self.batch_size)
        feats, _, _, _ = extract_features(self.model, pre, device=self.device, mesh=self.mesh)
        if self.part == "concat":
            f = torch.cat(list(feats), 1)
            return f / f.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return feats[("whole", "up", "down").index(self.part)]

    def evaluate(self, dataset, query=None, gallery=None, rerank: bool = False, logger=None):
        query = dataset.query if query is None else query
        gallery = dataset.gallery if gallery is None else gallery
        qf = self._feats(dataset, query)
        gf = self._feats(dataset, gallery)
        nq, ng = qf.shape[0], gf.shape[0]
        if rerank and (self.mesh is not None or (nq + ng) ** 2 * 4 > DENSE_RERANK_BYTES):
            # Market-1501 / DukeMTMC test splits and up, and any mesh: the
            # dense chain would hold some thirty (Q+G)^2 buffers; the
            # streaming evaluator reduces re-ranked query rows straight into
            # CMC / mAP.
            mAP, cmc, _ = streaming_rerank_eval(
                qf, gf, q_ids=[p for _, p, _ in query], g_ids=[p for _, p, _ in gallery],
                q_cams=[c for _, _, c in query], g_cams=[c for _, _, c in gallery],
                device=self.device, mesh=self.mesh)
            return _report(mAP, cmc, logger)
        if rerank:
            full = re_ranking(features=torch.cat([qf, gf]), device=self.device)
            distmat = full[:nq, nq:]
        elif nq * ng * 4 > 2**30:
            # MSMT17-scale galleries: the (Q, G) matrix is never one device
            # buffer; distances chunk by chunk into host memory, metrics
            # chunk below.
            chunk = max(2**30 // (ng * 4), 1)
            distmat = np.concatenate([pairwise_distance(qf[s:s + chunk], gf).cpu().numpy()
                                      for s in range(0, nq, chunk)], axis=0)
        else:
            distmat = pairwise_distance(qf, gf)
        return evaluate_all(distmat, query, gallery, logger=logger, device=self.device)


def train(*args, **kwargs):
    """The SSG self-training loop: see ``ssg_tpu_torch.train.ssg_loop.run_ssg``
    (imported when called, to keep the api import light)."""
    from ssg_tpu_torch.train.ssg_loop import run_ssg

    return run_ssg(*args, **kwargs)
