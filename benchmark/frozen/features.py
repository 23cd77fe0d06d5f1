"""Seeded feature geometry of a re-id train split.

Copied from ``chip_smoke.py`` (``identities``, ``clustered_features``,
``FEAT_NOISE``, ``CLUSTER_LATENT``, ``TRAIN_SKEW``) at commit 78531ab.
Identity centres are a normal draw in a ``latent``-dimensional subspace,
scaled to the norm of a full-width draw; each feature is its centre plus
``FEAT_NOISE`` times a normal draw, L2-normalised. Images per identity are
long-tailed: log-normal identity weights with sigma ``TRAIN_SKEW``.
Features come identity-ordered, as an extract emits them.
"""

from __future__ import annotations

import torch

FEAT_NOISE = 0.3
CLUSTER_LATENT = 32
TRAIN_SKEW = 0.8


def identities(gen: torch.Generator, n: int, ids: int, skew: float, dev) -> torch.Tensor:
    """Identity of each of ``n`` images (log-normal identity weights with
    sigma ``skew``), sorted."""
    w = torch.exp(skew * torch.randn(ids, generator=gen, device=dev))
    return torch.multinomial(w, n, replacement=True, generator=gen).sort().values


def clustered_features(gen: torch.Generator, assign: torch.Tensor, ids: int, dim: int,
                       latent: int) -> torch.Tensor:
    """L2-normalised (len(assign), dim) fp32: identity centre + FEAT_NOISE x
    noise, the centres a normal draw in a random ``latent``-dimensional
    subspace at the norm of a full-width draw."""
    dev = assign.device
    z = torch.randn((ids, latent), generator=gen, device=dev)
    basis, _ = torch.linalg.qr(torch.randn((dim, latent), generator=gen, device=dev))
    centres = z @ basis.T * (dim / latent) ** 0.5
    x = centres[assign] + FEAT_NOISE * torch.randn((assign.shape[0], dim), generator=gen,
                                                   device=dev)
    return x / x.norm(dim=1, keepdim=True)
