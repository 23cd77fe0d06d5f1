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

CUDA graph of the eval forward: on the card, ``extract_features`` replays a
batch's test transform, backbone and heads, from the uint8 batch to the
embeddings, as one captured CUDA graph, where the host would launch a few
hundred kernels a batch. The kernels, dtypes and order of operations are the
eager forward's. It does so where the batch is on a CUDA device, there is
no mesh of more than one rank, no ``torch.autocast`` region is active, and
no module of the model has a forward hook or pre-hook, nor is there a
global hook (``models.layers.no_hooks``); elsewhere every batch runs eager.
A batch's signature holds the images' shape, dtype and device, the TF32 and
cuDNN determinism flags, every parameter's and buffer's ``(data_ptr,
_version)``, and which caches of derived weights the modules hold
(``models.layers.derived_caches``: the casts of ``cast_masters``, the
BatchNorm folds of ``Bottleneck.folded``): the graph reads all of these by
address. A batch whose signature equals the held graph's replays it; one
whose signature equals the batch before it captures a graph in place of
the held one and replays it; any other runs eager, which builds those
caches and cuDNN's plans. So the first batch of a new signature runs eager,
the second captures, and later batches and calls with it replay; an
optimizer step, ``load_state_dict``, ``.to()`` or a train-mode forward
(which drops the folds) makes the next call capture anew; a ragged last
batch runs eager and leaves the held graph in place. A model holds at most
one graph, with its memory pool and static input and output, until
another capture replaces it or the model is collected. Each replayed batch counts once in the counter
``extract.graph_replays`` (``EXTRACT_GRAPH_REPLAYS``).
"""

from __future__ import annotations

import itertools
import weakref

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cluster import dbscan, select_eps
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.models.layers import derived_caches, no_hooks
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.metrics import rank_stats
from ssg_tpu_torch.ops.rerank import _re_ranking_impl, re_ranking
from ssg_tpu_torch.parallel import streaming_rerank_eval
from ssg_tpu_torch.parallel.dp import shard_batch
from ssg_tpu_torch.parallel.ring import all_gather
from ssg_tpu_torch.utils.profiling import count, span

__all__ = ["extract_features", "re_ranking", "cluster", "cluster_groups", "train",
           "pairwise_distance", "evaluate_all", "Evaluator"]

# Re-ranked evaluation streams (``parallel.streaming_rerank_eval``) once one
# fp32 (Q+G)^2 matrix would pass this many bytes, as the JAX package does.
DENSE_RERANK_BYTES = 2**30


EXTRACT_GRAPH_REPLAYS = "extract.graph_replays"  # the counter of replayed extract batches


@torch.no_grad()
def _forward_eval(model, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> (num_parts, B, F) L2-normalised embeddings."""
    return model(transforms.test_transform(images_u8))["embeddings"]


def _graphable(model, device: torch.device, multi: bool) -> bool:
    """Whether a replay would run what the eager forward runs: on the card,
    without a mesh of ranks, outside ``torch.autocast`` (whose casts and
    their cache a capture would bake in) and without a hook a replay would
    skip."""
    return (device.type == "cuda" and not multi and not torch.is_autocast_enabled("cuda")
            and no_hooks(model.modules()))


def _model_signature(model) -> tuple:
    """What a captured forward bakes in besides its input: the flags that
    choose its kernels, the address and version of every tensor it reads,
    and which cached casts and folds it reads (by identity)."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            tuple((t.data_ptr(), t._version)
                  for t in itertools.chain(model.parameters(), model.buffers())),
            tuple(id(c) for c in derived_caches(model)))


class _EvalGraph:
    """One model's captured eval forward: a static uint8 input, the graph
    and its static embeddings, with the signature it was captured on, and
    the signature of the batch that ran last."""

    def __init__(self):
        self.last = None
        self.free()

    def free(self):
        # caches: the cached casts and folds the graph reads, kept alive so
        # that no new cache takes the identity of one it was captured on.
        self.signature = self.graph = self.images = self.out = self.caches = None

    def forward(self, model, x: torch.Tensor, model_sig: tuple) -> tuple:
        """``(embeddings, model_sig)`` of batch ``x``: replayed, captured
        and replayed, or eager (then the model's signature anew, as the
        eager forward may have built caches)."""
        sig = (tuple(x.shape), x.dtype, x.device, model_sig)
        if sig != self.signature:
            if sig != self.last:
                emb = _forward_eval(model, x)
                model_sig = _model_signature(model)
                self.last = sig[:3] + (model_sig,)
                return emb, model_sig
            self._capture(model, x, sig)
        self.last = sig
        self.images.copy_(x)
        self.graph.replay()
        count(EXTRACT_GRAPH_REPLAYS)
        return self.out.clone(), model_sig  # callers keep results: each its own

    def _capture(self, model, x: torch.Tensor, sig: tuple):
        self.free()  # the old graph's pool goes before the new one fills
        images, graph = torch.empty_like(x), torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(x.device),
                              capture_error_mode="thread_local"):
            out = _forward_eval(model, images)
        self.signature, self.graph, self.images, self.out = sig, graph, images, out
        self.caches = derived_caches(model)


# model -> its _EvalGraph; weak, so that a graph goes with its model.
_eval_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


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

    On the card, without a mesh of ranks, autocast or hooks, a batch
    replays a CUDA graph of the test transform and the forward when its
    signature (the images' shape, dtype and device; the TF32 and cuDNN
    determinism flags; every parameter's and buffer's address and version;
    the cached casts and folds) equals the held graph's; the first batch of
    a signature runs eager and the second captures the graph (module
    docstring). The
    weights' part of the signature is taken once a call and again after an
    eager batch, which may build caches. The counter
    ``extract.graph_replays`` counts the replayed batches. Replayed and
    eager batches give the same embeddings.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    multi = mesh is not None and mesh.size > 1
    chunks, pids, cams, masks = [], [], [], []
    was_training = model.training
    model.eval()
    graph = _eval_graphs.setdefault(model, _EvalGraph()) if _graphable(model, dev, multi) else None
    model_sig = None if graph is None else _model_signature(model)
    try:
        for b, (images, p, c, mask) in enumerate(batches):
            with span("extract.batch", key=b):
                if multi:
                    images = shard_batch(mesh, images)
                x = torch.as_tensor(images, device=dev)
                if graph is None:
                    emb = _forward_eval(model, x)
                else:
                    emb, model_sig = graph.forward(model, x, model_sig)
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
