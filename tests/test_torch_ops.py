"""Port parity of the operator layer: ``ssg_tpu_torch.ops`` / ``.cluster``
against the JAX package and its numpy/sklearn oracles, on the same numpy
inputs (CPU). The port's CPU path is each kernel's plain version; the
CUDA kernel is held against it on a card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssg_tpu.cluster import dbscan as jax_dbscan
from ssg_tpu.cluster import select_eps as jax_select_eps
from ssg_tpu.ops.distance import pairwise_distance as jax_pairwise
from ssg_tpu.ops.l1 import _l1_pallas, _l1_xla
from ssg_tpu.ops.rerank import re_ranking as jax_re_ranking
from ssg_tpu.ops.topk import exact_min_k as jax_min_k
from ssg_tpu.oracle import dbscan_np, pairwise_distance_np, re_ranking_np, select_eps_np

from ssg_tpu_torch.cluster import dbscan, select_eps
from ssg_tpu_torch.ops import l1 as l1_mod
from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref
from ssg_tpu_torch.ops.rerank import re_ranking
from ssg_tpu_torch.ops.topk import exact_max_k, exact_min_k


@pytest.fixture
def feats(rng):
    # 20 identities x 10 instances, 64-dim: tie-free distances.
    centers = rng.normal(size=(20, 64)) * 2.0
    pts = centers[np.repeat(np.arange(20), 10)] + rng.normal(size=(200, 64))
    return pts.astype(np.float32)


# Ragged against every tile size of both sides (CUDA 64x64x32, Pallas 128).
@pytest.mark.parametrize("m,n,d", [(70, 33, 150), (5, 7, 3), (129, 64, 65), (1, 1, 1)])
def test_l1_matches_jax(rng, m, n, d):
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    ours = l1_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert ours.shape == (m, n) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(_l1_xla(jnp.asarray(x), jnp.asarray(y))),
                               rtol=0, atol=1e-5 * d)
    pallas = np.asarray(_l1_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5 * d)


def test_l1_dispatch_on_cpu(rng):
    x = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32))
    before = l1_mod.launches
    # CPU tensors take the plain version; no kernel launch is counted.
    torch.testing.assert_close(l1_distance(x), l1_distance_ref(x, x), rtol=0, atol=0)
    torch.testing.assert_close(l1_distance(x, impl="torch"), l1_distance_ref(x), rtol=0, atol=0)
    assert l1_mod.launches == before
    with pytest.raises(ValueError):
        l1_distance(x, impl="pallas")


@pytest.mark.parametrize("squared", [True, False])
def test_pairwise_distance(rng, squared):
    x = rng.normal(size=(57, 40)).astype(np.float32)
    y = rng.normal(size=(33, 40)).astype(np.float32)
    ours = pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), squared=squared).numpy()
    ref = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(y), squared=squared))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ours, pairwise_distance_np(x, y, squared=squared),
                               rtol=1e-5, atol=1e-4)
    # Symmetric default. Off the diagonal as above; on it, |x|^2 + |x|^2 - 2 x.x
    # cancels to an fp32 residue that sqrt magnifies, so it is only near 0.
    sym = pairwise_distance(torch.from_numpy(x), squared=squared).numpy()
    off = ~np.eye(len(x), dtype=bool)
    np.testing.assert_allclose(sym[off], pairwise_distance_np(x, squared=squared)[off],
                               rtol=1e-5, atol=1e-4)
    assert np.abs(np.diag(sym)).max() <= 1e-2


def test_exact_min_k_values_and_tie_free_indices(rng):
    ties = rng.integers(0, 5, size=(16, 50)).astype(np.float32)  # tie-heavy
    for k in (1, 7, 50, 80):
        v, _ = exact_min_k(torch.from_numpy(ties), k)
        jv, _ = jax_min_k(jnp.asarray(ties), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        mv, _ = exact_max_k(torch.from_numpy(ties), k)
        np.testing.assert_array_equal(mv.numpy(), -np.sort(-ties, axis=1)[:, :min(k, 50)])
    distinct = rng.permutation(16 * 50).reshape(16, 50).astype(np.float32)
    v, i = exact_min_k(torch.from_numpy(distinct), 9)
    jv, ji = jax_min_k(jnp.asarray(distinct), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("k1,k2,lam", [(20, 6, 0.1), (7, 1, 0.3), (25, 30, 0.2)])
def test_re_ranking_matches_jax_and_oracle(feats, k1, k2, lam):
    ours = re_ranking(features=feats, k1=k1, k2=k2, lambda_value=lam, device="cpu").numpy()
    ref = np.asarray(jax_re_ranking(features=jnp.asarray(feats), k1=k1, k2=k2,
                                    lambda_value=lam))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, re_ranking_np(features=feats, k1=k1, k2=k2,
                                                   lambda_value=lam), rtol=0, atol=1e-5)


def test_re_ranking_from_dist(feats):
    d = pairwise_distance_np(feats, squared=False)
    ours = re_ranking(dist=d, device="cpu").numpy()
    ref = np.asarray(jax_re_ranking(dist=jnp.asarray(d)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        re_ranking(device="cpu")


@pytest.mark.parametrize("rho", [1.6e-3, 0.02, 0.1, 0.5])
def test_select_eps(feats, rho):
    d = re_ranking_np(features=feats)
    ours = float(select_eps(torch.from_numpy(d), rho))
    assert ours == pytest.approx(float(jax_select_eps(jnp.asarray(d), rho=rho)), rel=1e-6)
    assert ours == pytest.approx(select_eps_np(d, rho=rho), rel=1e-6)


def test_select_eps_ties_and_rounding():
    # Integer distances: heavy ties at the k-th value; M = 45 entries so
    # rho * M lands on .5 for rho = 0.1 (4.5 -> 4, half-to-even).
    d = np.abs(np.subtract.outer(np.arange(10), np.arange(10)) % 3).astype(np.float32) + 1
    np.fill_diagonal(d, 0)
    for rho in (0.1, 1 / 45, 0.3, 1.0):
        ours = float(select_eps(torch.from_numpy(d), rho))
        assert ours == pytest.approx(float(jax_select_eps(jnp.asarray(d), rho=rho)), rel=1e-6)
        assert ours == pytest.approx(select_eps_np(d, rho=rho), rel=1e-6)


def _check_dbscan(d, eps, min_samples):
    ours, n = dbscan(torch.from_numpy(d), eps, min_samples)
    ref, _ = dbscan_np(d, eps=eps, min_samples=min_samples)
    jl, jn = jax_dbscan(jnp.asarray(d), eps, min_samples=min_samples)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jl))
    assert int(n) == int(jn) == ref.max() + 1


@pytest.mark.parametrize("eps_scale", [0.5, 1.0, 2.0])
def test_dbscan_exact_labels(feats, eps_scale):
    d = pairwise_distance_np(feats, squared=False)
    _check_dbscan(d, select_eps_np(d, rho=0.02) * eps_scale, 4)


def test_dbscan_tie_heavy_and_all_noise(rng):
    # Integer distances: many points exactly at eps (closed ball).
    pts = rng.integers(0, 6, size=(60, 2))
    d = np.abs(pts[:, None, :] - pts[None, :, :]).sum(-1).astype(np.float32)
    for eps, ms in [(1.0, 3), (2.0, 4), (0.5, 2)]:
        _check_dbscan(d, eps, ms)
    far = np.full((12, 12), 10.0, np.float32)
    np.fill_diagonal(far, 0.0)
    labels, n = dbscan(torch.from_numpy(far), 1.0, 4)
    assert int(n) == 0 and (labels.numpy() == -1).all()
    _check_dbscan(far, 1.0, 4)
