"""Port parity of ``ssg_tpu_torch.parallel`` over ranks (CPU, gloo).

P = 2 and 4 gloo processes (``tests/torch_dist_ranks.py``, one spawn a P
for the whole file) run the ring primitives, the sharded dense chain
(distance, eps, DBSCAN), the sharded re-ranking and the streaming
clustering and re-ranked evaluation on seeded inputs; this process runs
the JAX functions on ``make_mesh(P)`` (the 8-device virtual CPU mesh) on
the same inputs. Tolerances:

* labels, cluster counts and fallback codes are equal (``sharded_dbscan``
  on JAX's own matrix and eps exactly so);
* distances, re-ranked distances and eps within fp32 reduction-order
  ulps: 1e-5 relative (of each matrix's largest entry for distances);
* the streaming evaluator's mAP within 1e-6, its CMC equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssg_tpu.parallel import make_mesh as jax_make_mesh
from ssg_tpu.parallel import rerank as jax_rerank
from ssg_tpu.parallel import sharded as jax_sharded
from ssg_tpu.parallel import streaming as jax_streaming

from ssg_tpu_torch.parallel import make_mesh, mesh as mesh_mod, multihost, streaming
from ssg_tpu_torch.parallel.dp import shard_batch

import torch_dist_ranks

KW = dict(k1=8, k2=3, lambda_value=0.1, rho=0.02, min_samples=3)
STREAM = dict(KW)
CHUNK = 8
N_DENSE = 203  # ragged: pads to a multiple of P
N_STREAM = 250


def _feats(seed, n, ids, dim=24, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(ids, dim))
    x = centers[rng.integers(0, ids, n)] + spread * rng.normal(size=(n, dim))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _eval_inputs():
    rng = np.random.default_rng(11)
    x = _feats(11, 37 + 150, 20)
    ids = rng.integers(0, 20, 187)
    cams = rng.integers(0, 6, 187)
    return {"qf": x[:37], "gf": x[37:], "q_ids": ids[:37], "g_ids": ids[37:],
            "q_cams": cams[:37], "g_cams": cams[37:]}


def _jax_dense(feats, p):
    mesh = jax_make_mesh(p)
    dist = np.asarray(jax_sharded.sharded_pairwise_distance(jnp.asarray(feats), mesh))
    eps = float(jax_sharded.sharded_select_eps(jnp.asarray(dist), mesh, rho=KW["rho"]))
    labels, nc = jax_sharded.sharded_dbscan(jnp.asarray(dist), eps, mesh,
                                            min_samples=KW["min_samples"])
    rr = np.asarray(jax_rerank.sharded_re_ranking(jnp.asarray(feats), mesh, k1=KW["k1"],
                                                  k2=KW["k2"], lambda_value=KW["lambda_value"]))
    return dist, eps, np.asarray(labels), int(nc), rr


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request):
    """One spawn of P gloo ranks running every check; JAX's results on
    ``make_mesh(P)`` beside them."""
    p = request.param
    feats = _feats(5, N_DENSE, 14)
    groups = np.stack([_feats(s, N_STREAM, 16) for s in (9, 3, 21)])
    dist, eps, labels, nc, rr = _jax_dense(feats, p)
    payload = {"kw": KW, "feats": feats, "jax_dist": dist, "jax_eps": eps, "groups": groups,
               "chunk": CHUNK, "eval": _eval_inputs()}
    results = torch_dist_ranks.run_ranks(torch_dist_ranks.parallel_chain, p, payload)
    return {"p": p, "payload": payload, "results": results,
            "jax": {"dist": dist, "eps": eps, "labels": labels, "n_clusters": nc, "rerank": rr}}


def _stitch(results, key, n):
    return torch.cat([r[key] for r in results])[:n].numpy()


def _close(a, b, rel=1e-5):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * float(np.abs(b).max()))


def test_ring_primitives_over_ranks(ranks):
    for r in ranks["results"]:
        assert all(r["ring"].values()), r["ring"]


def test_sharded_distance_and_eps_match_jax(ranks):
    j = ranks["jax"]
    _close(_stitch(ranks["results"], "dist", N_DENSE), j["dist"])
    for r in ranks["results"]:
        assert r["eps"] == pytest.approx(j["eps"], rel=1e-5)


def test_sharded_dbscan_labels_equal_jax(ranks):
    j = ranks["jax"]
    for r in ranks["results"]:
        np.testing.assert_array_equal(r["labels_on_jax"], j["labels"])
        np.testing.assert_array_equal(r["labels"], j["labels"])
        assert r["n_clusters"] == j["n_clusters"]


def test_sharded_re_ranking_matches_jax(ranks):
    _close(_stitch(ranks["results"], "rerank", N_DENSE), ranks["jax"]["rerank"])


def _jax_streaming(ranks):
    mesh = jax_make_mesh(ranks["p"])
    diag = {}
    groups = ranks["payload"]["groups"]
    labels, counts, epss = jax_streaming.streaming_cluster_groups(
        jnp.asarray(groups), mesh, chunk=CHUNK, diag=diag, **STREAM)
    return np.asarray(labels), counts, epss, diag["fallback_code"]


def test_streaming_cluster_groups_match_jax_mesh(ranks):
    labels, counts, epss, codes = _jax_streaming(ranks)
    for r in ranks["results"]:
        got_labels, got_counts, got_eps = r["groups"]
        np.testing.assert_array_equal(got_labels, labels)
        assert got_counts == counts
        assert r["groups_codes"] == codes
        np.testing.assert_allclose(got_eps, epss, rtol=1e-5)


def test_streaming_fallback_sweeps_match_jax_mesh(ranks):
    diag = {}
    x = ranks["payload"]["groups"][0]
    labels, nc, eps = jax_streaming.streaming_cluster(jnp.asarray(x), jax_make_mesh(ranks["p"]),
                                                      chunk=CHUNK, band_cap=0, diag=diag,
                                                      **STREAM)
    for r in ranks["results"]:
        got_labels, got_nc, got_eps = r["fallback"]
        np.testing.assert_array_equal(got_labels, np.asarray(labels))
        # band_cap 0 disables the fused path: bit 1 (a slot group over its
        # capacity) and the exact sweeps.
        assert got_nc == int(nc) and r["fallback_code"] == diag["fallback_code"]
        assert r["fallback_code"] & 1
        assert got_eps == pytest.approx(float(eps), rel=1e-5)


def test_streaming_over_ranks_equals_one_device(ranks):
    """The same labels and counts as the one-device pipeline (whose sample,
    and so its fallback codes, may differ)."""
    x = ranks["payload"]["groups"]
    labels, counts, epss = streaming.streaming_cluster_groups(x, chunk=CHUNK, device="cpu",
                                                              **STREAM)
    for r in ranks["results"]:
        np.testing.assert_array_equal(r["groups"][0], labels)
        assert r["groups"][1] == counts
        np.testing.assert_allclose(r["groups"][2], epss, rtol=1e-5)


def test_streaming_rerank_eval_matches_jax_mesh(ranks):
    ev = ranks["payload"]["eval"]
    mAP, cmc, nv = jax_streaming.streaming_rerank_eval(
        jnp.asarray(ev["qf"]), jnp.asarray(ev["gf"]), jax_make_mesh(ranks["p"]), ev["q_ids"],
        ev["g_ids"], ev["q_cams"], ev["g_cams"], k1=KW["k1"], k2=KW["k2"], chunk=CHUNK)
    for r in ranks["results"]:
        got_map, got_cmc, got_nv = r["eval"]
        assert got_nv == nv
        assert got_map == pytest.approx(mAP, abs=1e-6)
        np.testing.assert_array_equal(got_cmc, np.asarray(cmc))


# ---- the mesh, its helpers and the stripe geometry (no spawn) -------------------

def test_mesh_of_one_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group) == (0, 1, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(2, device="cpu")


def test_nccl_duplicate_device_check_names_the_ranks():
    mesh_mod.check_distinct_devices(["h/GPU-a", "h/GPU-b", "g/GPU-a"])
    with pytest.raises(RuntimeError, match=r"ranks 0 and 2 share the device h/GPU-a"):
        mesh_mod.check_distinct_devices(["h/GPU-a", "h/GPU-b", "h/GPU-a"])


def test_shard_batch_and_global_put_take_the_rank_stripe():
    x = np.arange(24).reshape(8, 3)
    for rank in range(4):
        mesh = mesh_mod.Mesh(None, rank, 4, torch.device("cpu"), "gloo")
        np.testing.assert_array_equal(shard_batch(mesh, x), x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(multihost.global_put(mesh, x).numpy(),
                                      x[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh_mod.Mesh(None, 0, 3, torch.device("cpu"), "gloo"), x)


@pytest.mark.parametrize("n,p,chunk", [(250, 4, 8), (203, 2, 16), (40, 8, 512), (4097, 4, 512)])
def test_stripe_geometry_is_jaxs(n, p, chunk):
    """Padding, stripe and chunk as JAX's ``_stripe_config`` on make_mesh(P)."""
    x = np.zeros((n, 4), np.float32)
    _, jn, jnpad, jr, _, jc = jax_streaming._stripe_config(jnp.asarray(x), jax_make_mesh(p),
                                                           chunk, None)
    _, tn, tnpad, _, tc = streaming._stripe_config(x, chunk, None, torch.device("cpu"), p)
    assert (tn, tnpad, tnpad // p, tc) == (jn, jnpad, jr, jc)
