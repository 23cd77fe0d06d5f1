"""Port parity of ``ssg_tpu_torch.parallel.streaming`` (CPU).

The same seeded features go through the JAX package's streaming
clustering (one-device mesh: the port's geometry, so the phase-3 sample
takes the same rows and the fallback codes must agree; and the 8-device
mesh where it runs, whose larger sample may pick other codes but not other
labels), through the port's streaming functions and through the port's
dense chain (``api.re_ranking`` + ``api.cluster``). Labels and cluster
counts must be equal, eps within 1e-4 relative; re-ranked evaluation mAP
within 1e-5 and CMC within 1e-6. The cases are those of
``tests/test_streaming.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.parallel import make_mesh
from ssg_tpu.parallel import streaming as jax_streaming

from ssg_tpu_torch import api, models
from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.ops.metrics import evaluate_rank
from ssg_tpu_torch.parallel import streaming
from ssg_tpu_torch.parallel.streaming import (streaming_cluster, streaming_cluster_groups,
                                              streaming_rerank_eval)

KW = dict(k1=8, k2=3, lambda_value=0.1, rho=0.02, min_samples=3)


def _feats(seed, n, ids, dim=24, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(ids, dim))
    x = centers[rng.integers(0, ids, n)] + spread * rng.normal(size=(n, dim))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _dense(x, k1=8, k2=3, rho=0.02, min_samples=3):
    dist = api.re_ranking(features=x, k1=k1, k2=k2, lambda_value=0.1, device="cpu")
    return api.cluster(dist, rho=rho, min_samples=min_samples, device="cpu")


def _port(x, **kw):
    diag = {}
    labels, n_clusters, eps = streaming_cluster(x, diag=diag, device="cpu", **kw)
    return labels, n_clusters, eps, diag


def _jax(x, mesh, **kw):
    diag = {}
    labels, n_clusters, eps = jax_streaming.streaming_cluster(jnp.asarray(x), mesh, diag=diag,
                                                              **kw)
    return np.asarray(labels), int(n_clusters), float(eps), diag


# (seed, n, ids, chunk, options, the fallback code both packages take). The
# fast path needs a sample of more than a handful of rows: on one device the
# sample is one chunk, so its case runs chunk 16.
CASES = {
    "n96": (3, 96, 12, 4, {}, 4),
    "n130": (3, 130, 12, 8, {}, 2),
    "n416": (3, 416, 12, 16, {}, 4),
    "col_blocks2": (7, 160, 14, 8, dict(col_blocks=2), 0),
    "col_blocks4": (7, 160, 14, 8, dict(col_blocks=4), 0),
    "fast_path": (9, 256, 16, 16, {}, 0),
    "band_cap0": (9, 256, 16, 16, dict(band_cap=0), 3),
    "eps_cap1": (9, 256, 16, 16, dict(eps_cap=1), 16),
    "band_cap1": (21, 160, 12, 8, dict(band_cap=1), 7),
    "support_cap2": (21, 160, 12, 8, dict(support_cap=2), 14),
    "group_overflow": (23, 256, 16, 8, dict(band_cap=8), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_cluster_matches_jax_and_dense_chain(case):
    seed, n, ids, chunk, opts, code = CASES[case]
    x = _feats(seed, n, ids)
    labels, n_clusters, eps, diag = _port(x, chunk=chunk, **KW, **opts)
    jl, jn, je, jdiag = _jax(x, make_mesh(1), chunk=chunk, **KW, **opts)
    dl, dn, de = _dense(x)
    assert dn > 0  # the comparison is not trivial
    assert labels.dtype == np.int32 and labels.shape == (n,)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(labels, dl)
    assert n_clusters == jn == dn
    assert eps == pytest.approx(je, rel=1e-4) and eps == pytest.approx(de, rel=1e-4)
    assert diag["fallback_code"] == jdiag["fallback_code"]
    assert diag["band_fallback"] == jdiag["band_fallback"]
    if code is not None:
        assert diag["fallback_code"] == code
    if case == "fast_path":
        assert diag["band_fallback"] is False
    if case in ("band_cap0", "band_cap1", "support_cap2", "group_overflow"):
        assert diag["band_fallback"] is True and diag["fallback_code"] & (1 | 8)
    if case == "eps_cap1":  # eps alone took the two-sweep form
        assert diag["band_fallback"] is False


def test_streaming_cluster_matches_jax_on_eight_devices():
    x = _feats(3, 416, 12)
    labels, n_clusters, eps, _ = _port(x, chunk=16, **KW)
    jl, jn, je, _ = _jax(x, make_mesh(8), chunk=16, **KW)
    np.testing.assert_array_equal(labels, jl)
    assert n_clusters == jn and eps == pytest.approx(je, rel=1e-4)


def test_streaming_tail_tier_equals_untiered(monkeypatch):
    """The main sweep corrects the tail slots of a chunk after the sweep,
    for the chunks whose exact group counts need them. With a head tier of 2
    slots nearly every chunk needs one; the result must equal the run
    whose tier is the whole group capacity."""
    x = _feats(9, 256, 16)
    want = _port(x, chunk=16, **KW)
    monkeypatch.setattr(streaming, "_tier_width", lambda gcap: min(gcap, 2))
    got = _port(x, chunk=16, **KW)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    for diag in (got[3], want[3]):
        assert set(diag.pop("seconds")) == {"phases12", "sample", "main_sweep", "eps",
                                            "adjacency", "dbscan"}
    assert got[3] == want[3]


def test_streaming_fast_path_deterministic_on_ties():
    """Duplicated points (tied distances): no candidate (1) or support (8)
    overflow, the result does not depend on the V column blocking, and
    every duplicate group co-clusters, in the fallback too."""
    base = _feats(13, 24, 4)
    x = np.repeat(base, 4, axis=0)  # 96 rows
    kw = dict(k1=6, k2=2, lambda_value=0.1, rho=0.05, min_samples=3, chunk=4)
    labels, n_clusters, eps, diag = _port(x, **kw)
    assert diag["fallback_code"] & (1 | 8) == 0
    labels2, n2, eps2, _ = _port(x, col_blocks=2, **kw)
    np.testing.assert_array_equal(labels, labels2)
    assert eps == eps2 and n_clusters == n2
    fb_labels, fb_n, _, _ = _port(x, band_cap=0, **kw)
    for run in (labels, fb_labels):
        groups = run.reshape(24, 4)
        assert (groups == groups[:, :1]).all() and (groups >= 0).all()
    assert fb_n > 0


def test_streaming_fast_path_on_identity_ordered_features():
    """Identity-ordered features (as an extract emits them) at SSG's own
    settings: the whole fast path engages (fallback_code 0) with the
    default caps, and the labels are the dense chain's."""
    rng = np.random.default_rng(29)
    n, ids = 1024, 48
    c = rng.normal(size=(ids, 96))
    x = c[np.sort(rng.integers(0, ids, n))] + 0.25 * rng.normal(size=(n, 96))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    kw = dict(k1=20, k2=6, lambda_value=0.1, rho=1.6e-3, min_samples=4)
    labels, n_clusters, eps, diag = _port(x, chunk=128, **kw)
    assert diag["fallback_code"] == 0, diag
    dl, dn, de = _dense(x, k1=20, k2=6, rho=1.6e-3, min_samples=4)
    assert dn > 0 and n_clusters == dn
    np.testing.assert_array_equal(labels, dl)
    assert eps == pytest.approx(de, rel=1e-4)


def test_streaming_cluster_groups_match_separate_calls_and_jax():
    groups = np.stack([_feats(41, 160, 12), _feats(42, 160, 14), _feats(43, 160, 10)])
    kw = dict(KW, chunk=8)
    diag = {}
    labels_g, counts_g, eps_g = streaming_cluster_groups(groups, diag=diag, device="cpu", **kw)
    assert labels_g.shape == (3, 160) and diag["diag_vec"].shape == (3, 9)
    jl, jc, je = jax_streaming.streaming_cluster_groups(jnp.asarray(groups), make_mesh(1), **kw)
    np.testing.assert_array_equal(labels_g, np.asarray(jl))
    assert counts_g == jc and eps_g == pytest.approx(je, rel=1e-4)
    for g in range(3):  # dense parity of single calls: the parametrised test above
        labels, n_clusters, eps, d = _port(groups[g], **kw)
        np.testing.assert_array_equal(labels_g[g], labels)
        assert counts_g[g] == n_clusters > 0 and eps_g[g] == eps
        assert diag["fallback_code"][g] == d["fallback_code"]


def test_streaming_tiny_k_clamp_matches_jax():
    x = _feats(5, 40, 5)
    kw = dict(k1=64, k2=10, rho=0.05, min_samples=2, chunk=8)
    labels, n_clusters, eps, diag = _port(x, **kw)
    jl, jn, je, jdiag = _jax(x, make_mesh(1), **kw)
    assert labels.shape == (40,) and n_clusters >= 1
    np.testing.assert_array_equal(labels, jl)
    assert n_clusters == jn and eps == pytest.approx(je, rel=1e-4)
    assert diag["fallback_code"] == jdiag["fallback_code"]


def test_streaming_return_final_is_the_dense_matrix():
    x = _feats(3, 96, 12)
    *_, final = streaming_cluster(x, chunk=8, return_final=True, device="cpu", **KW)
    dense = api.re_ranking(features=x, k1=8, k2=3, lambda_value=0.1, device="cpu")
    assert final.shape == (96, 96)
    torch.testing.assert_close(final, dense, rtol=0, atol=2e-6)


def _protocol(seed, ids, sizes):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(ids, 24))
    out = []
    for n in sizes:
        pid = rng.integers(0, ids, n)
        cam = rng.integers(0, 4, n)
        x = centers[pid] + 0.25 * rng.normal(size=(n, 24))
        out.append(((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), pid, cam))
    return out


@pytest.mark.parametrize("seed,ids,nq,ng,k1,k2", [(11, 10, 60, 140, 8, 3), (17, 6, 5, 93, 6, 2),
                                                 (17, 6, 13, 51, 6, 2)])
def test_streaming_rerank_eval_matches_jax_and_dense(seed, ids, nq, ng, k1, k2):
    """Including the ragged cases: fewer queries than a chunk, a ragged
    gallery, a chunk larger than the query rows."""
    (qf, q_ids, q_cams), (gf, g_ids, g_cams) = _protocol(seed, ids, (nq, ng))
    kw = dict(k1=k1, k2=k2, lambda_value=0.1, chunk=8)
    got_map, got_cmc, nv = streaming_rerank_eval(qf, gf, q_ids, g_ids, q_cams, g_cams,
                                                 device="cpu", **kw)
    assert nv > 0 and got_cmc.shape == (100,)
    j_map, j_cmc, jnv = jax_streaming.streaming_rerank_eval(
        jnp.asarray(qf), jnp.asarray(gf), make_mesh(1), q_ids, g_ids, q_cams, g_cams, **kw)
    assert nv == jnv
    assert got_map == pytest.approx(j_map, abs=1e-5)
    np.testing.assert_allclose(got_cmc, j_cmc, atol=1e-6)
    full = api.re_ranking(features=np.concatenate([qf, gf]), k1=k1, k2=k2, lambda_value=0.1,
                          device="cpu")
    want = evaluate_rank(full[:nq, nq:], *(torch.from_numpy(a) for a in (q_ids, g_ids, q_cams,
                                                                         g_cams)))
    assert got_map == pytest.approx(float(want["mAP"]), abs=1e-5)
    np.testing.assert_allclose(got_cmc, want["cmc"].numpy(), atol=1e-6)


def test_streaming_rerank_eval_rows_are_the_dense_rows():
    """The rows the evaluator ranks (its first query chunk, ``diag``) are
    the dense re-ranked matrix's query-gallery rows, within the tolerance of
    ``streaming_cluster``'s ``return_final``."""
    (qf, q_ids, q_cams), (gf, g_ids, g_cams) = _protocol(11, 10, (60, 140))
    diag = {}
    streaming_rerank_eval(qf, gf, q_ids, g_ids, q_cams, g_cams, k1=8, k2=3, chunk=8, diag=diag,
                          device="cpu")
    full = api.re_ranking(features=np.concatenate([qf, gf]), k1=8, k2=3, device="cpu")
    assert diag["final_rows"].shape == (8, 140)
    torch.testing.assert_close(diag["final_rows"], full[:8, 60:], rtol=0, atol=2e-6)


def test_streaming_rerank_eval_hit_overflow_takes_the_argsort_form():
    """Two identities: every query has far more than 64 relevant gallery
    columns, so every chunk is redone with the argsort form after the sweep."""
    (qf, q_ids, q_cams), (gf, g_ids, g_cams) = _protocol(19, 2, (20, 300))
    got = streaming_rerank_eval(qf, gf, q_ids, g_ids, q_cams, g_cams, k1=8, k2=3, chunk=8,
                                device="cpu")
    full = api.re_ranking(features=np.concatenate([qf, gf]), k1=8, k2=3, device="cpu")
    want = evaluate_rank(full[:20, 20:], *(torch.from_numpy(a) for a in (q_ids, g_ids, q_cams,
                                                                         g_cams)))
    assert got[0] == pytest.approx(float(want["mAP"]), abs=1e-5)
    np.testing.assert_allclose(got[1], want["cmc"].numpy(), atol=1e-6)


def test_evaluator_routes_large_rerank_to_streaming(monkeypatch):
    """Above the threshold ``Evaluator.evaluate(rerank=True)`` streams; with
    the threshold lowered it streams at a small size and must equal the
    dense re-ranked evaluation and the JAX evaluator's streaming route."""
    ds = datasets.create("market1501", scale="tiny", seed=7)
    jds = jax_datasets.create("market1501", scale="tiny", seed=7)
    for d in (ds, jds):
        render = d.render
        d.render = lambda fnames, render=render: render(fnames)[:, ::4, ::4, :]
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ev = api.Evaluator(model, batch_size=16, device="cpu")
    dense = ev.evaluate(ds, rerank=True)
    # The routing is the point from here: the same features, extracted once.
    qf, gf = ev._feats(ds, ds.query), ev._feats(ds, ds.gallery)
    monkeypatch.setattr(ev, "_feats", lambda dataset, items: qf if items is ds.query else gf)

    calls = []
    real = streaming_rerank_eval

    def spy(*args, **kwargs):
        calls.append(kwargs["device"])
        return real(*args, **kwargs)

    monkeypatch.setattr(api, "DENSE_RERANK_BYTES", 0)
    monkeypatch.setattr(api, "streaming_rerank_eval", spy)
    routed = ev.evaluate(ds, rerank=True)
    assert calls == [torch.device("cpu")]
    assert routed["mAP"] == pytest.approx(dense["mAP"], abs=1e-5)
    np.testing.assert_allclose(routed["cmc"], dense["cmc"], atol=1e-6)

    # JAX's evaluator streams whenever it is given a mesh; same features.
    j_map, j_cmc, _ = jax_streaming.streaming_rerank_eval(
        jnp.asarray(qf.numpy()), jnp.asarray(gf.numpy()), make_mesh(1),
        [p for _, p, _ in jds.query], [p for _, p, _ in jds.gallery],
        [c for _, _, c in jds.query], [c for _, _, c in jds.gallery])
    assert routed["mAP"] == pytest.approx(j_map, abs=1e-5)
    np.testing.assert_allclose(routed["cmc"], j_cmc, atol=1e-6)
