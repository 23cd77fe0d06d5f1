"""Public API of the port: extract -> re-rank -> auto-eps DBSCAN.

Counterpart of ``ssg_tpu/api.py`` for the main path (bench config-1):
``extract_features``, ``re_ranking``, ``cluster`` and ``cluster_groups``.
Every entry point runs on the card unless ``device="cpu"`` is given
(``_device.py``). Hosts see uint8 batches in and numpy labels out.
"""

from __future__ import annotations

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cluster import dbscan, select_eps
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.rerank import _re_ranking_impl, re_ranking

__all__ = ["extract_features", "re_ranking", "cluster", "cluster_groups",
           "pairwise_distance"]


@torch.no_grad()
def _forward_eval(model, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> (num_parts, B, F) L2-normalised embeddings."""
    return model(transforms.test_transform(images_u8))


def extract_features(model, batches, device=None):
    """Part embeddings of every real row of ``batches``.

    ``batches`` iterates ``(images_u8, pids, cams, mask)`` (numpy or tensors;
    ``data.Preprocessor``'s contract); ``mask`` marks real rows, and padding
    rows are dropped. ``model`` must already be on ``device`` and in eval
    mode. Returns ``(features (num_parts, N, F) on device, pids, cams)``.
    """
    dev = resolve_device(device)
    chunks, pids, cams, masks = [], [], [], []
    for images, p, c, mask in batches:
        chunks.append(_forward_eval(model, torch.as_tensor(images, device=dev)))
        pids.append(np.asarray(p))
        cams.append(np.asarray(c))
        masks.append(np.asarray(mask, dtype=bool))
    keep = np.concatenate(masks)
    feats = torch.cat(chunks, 1)[:, torch.as_tensor(np.flatnonzero(keep), device=dev)]
    return feats, np.concatenate(pids)[keep], np.concatenate(cams)[keep]


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
        (its plain version; the reference the kernel path is held against).
      dist_impl: ``"auto"`` (the cuBLAS distance) or ``"kernel"`` (the CUDA
        distance kernel on the card), as ``ops.distance.pairwise_distance``.

    Returns (labels (num_parts, N) np.int32, n_clusters list, eps list).
    """
    f = torch.as_tensor(feats, device=resolve_device(device))
    labels, counts, epss = [], [], []
    for g in range(f.shape[0]):
        original = pairwise_distance(f[g], squared=True, impl=dist_impl)
        dist = _re_ranking_impl(original, int(k1), int(k2), float(lambda_value), l1_impl)
        eps_g = select_eps(dist, rho=rho)
        labels_g, n_g = dbscan(dist, eps_g, min_samples=int(min_samples))
        labels.append(labels_g)
        counts.append(n_g)
        epss.append(eps_g)
    return (
        torch.stack(labels).cpu().numpy(),
        [int(c) for c in torch.stack(counts).cpu()],
        [float(e) for e in torch.stack(epss).cpu()],
    )
