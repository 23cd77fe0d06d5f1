"""Port parity of the evaluation layer: ``ops.metrics`` (CMC / mAP),
``api.evaluate_all`` and ``api.Evaluator``, against the JAX package and the
numpy oracle on the same inputs (CPU). The sort is stable on both sides, so
tied distances rank alike: CMC must be exact, mAP within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu import api as jax_api
from ssg_tpu import models as jax_models
from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.ops.metrics import evaluate_rank as jax_evaluate_rank
from ssg_tpu.ops.metrics import rank_stats as jax_rank_stats
from ssg_tpu.ops.metrics import rank_stats_masked as jax_rank_stats_masked
from ssg_tpu.oracle import cmc_np, mean_ap_np

from ssg_tpu_torch import api, models
from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.ops.metrics import evaluate_rank, rank_stats, rank_stats_masked


def _protocol(rng, nq, ng, ids, cams, ties: bool):
    q_ids = rng.integers(0, ids, nq)
    g_ids = rng.integers(0, ids, ng)
    q_cams = rng.integers(0, cams, nq)
    g_cams = rng.integers(0, cams, ng)
    if ties:  # quantised distances: many exact ties, broken by gallery order
        dist = (rng.integers(0, 5, (nq, ng)) / 4.0).astype(np.float32)
    else:
        dist = rng.random((nq, ng)).astype(np.float32)
    return dist, q_ids, g_ids, q_cams, g_cams


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True), (3, False)])
def test_rank_stats_match_jax(seed, ties):
    args = _protocol(np.random.default_rng(seed), 32, 120, 12, 3, ties)
    ours = rank_stats(*_t(*args))
    ref = jax_rank_stats(*map(jnp.asarray, args))
    assert float(ours[0]) == pytest.approx(float(ref[0]), rel=1e-6)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))  # CMC counts: exact
    assert int(ours[2]) == int(ref[2])
    res = evaluate_rank(*_t(*args))
    jres = jax_evaluate_rank(*map(jnp.asarray, args))
    assert float(res["mAP"]) == pytest.approx(float(jres["mAP"]), abs=1e-6)
    np.testing.assert_array_equal(res["cmc"].numpy(), np.asarray(jres["cmc"]))
    if not ties:  # the oracle's numpy argsort is not stable
        assert float(res["mAP"]) == pytest.approx(mean_ap_np(*args), abs=1e-6)
        np.testing.assert_allclose(res["cmc"].numpy(), cmc_np(*args, topk=100), atol=1e-6)


def test_rank_stats_masked_matches_jax(rng):
    # Row and column masks, as the streaming evaluator feeds them: padding
    # rows contribute nothing, masked columns leave every valid sublist.
    args = _protocol(rng, 24, 90, 6, 3, ties=True)
    row_mask = rng.random(24) < 0.7
    col_mask = rng.random(90) < 0.8
    ours = rank_stats_masked(*_t(*args), *_t(row_mask, col_mask))
    ref = jax_rank_stats_masked(*map(jnp.asarray, args), jnp.asarray(row_mask),
                                jnp.asarray(col_mask))
    assert float(ours[0]) == pytest.approx(float(ref[0]), rel=1e-6)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert int(ours[2]) == int(ref[2]) < int(rank_stats(*_t(*args))[2])


def test_evaluate_all_chunked_matches_dense(rng):
    dist, qi, gi, qc, gc = _protocol(rng, 23, 57, 6, 3, ties=False)
    query = [(f"q{i}", int(p), int(c)) for i, (p, c) in enumerate(zip(qi, qc))]
    gallery = [(f"g{i}", int(p), int(c)) for i, (p, c) in enumerate(zip(gi, gc))]
    full = api.evaluate_all(dist, query, gallery, device="cpu")
    chunked = api.evaluate_all(dist, query, gallery, query_chunk=7, device="cpu")
    ref = jax_api.evaluate_all(dist, query, gallery)
    assert full["mAP"] == pytest.approx(ref["mAP"], abs=1e-6)
    np.testing.assert_array_equal(full["cmc"], ref["cmc"])
    assert chunked["mAP"] == pytest.approx(full["mAP"], abs=1e-6)
    np.testing.assert_allclose(chunked["cmc"], full["cmc"], atol=1e-6)


def _evaluators():
    """The same tiny set and weights in both packages (shallow bottleneck
    ResNet, fp32, 64x32 images)."""
    ds = datasets.create("market1501", scale="tiny", seed=7)
    jds = jax_datasets.create("market1501", scale="tiny", seed=7)
    for d in (ds, jds):
        render = d.render
        d.render = lambda fnames, render=render: render(fnames)[:, ::4, ::4, :]
    fm = jax_models.SSGResNet(stage_sizes=(1, 1), num_features=16, dtype=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    variables = fm.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)), train=False)
    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    return ds, jds, fm, variables, tm


def test_evaluator_plain_and_reranked_match_jax():
    ds, jds, fm, variables, tm = _evaluators()
    ev = api.Evaluator(tm, batch_size=16, device="cpu")
    jev = jax_api.Evaluator(fm, variables, batch_size=16)

    captured = []

    class Probe:
        def metric(self, **kv):
            captured.append(kv)

    for rerank in (False, True):
        ours = ev.evaluate(ds, rerank=rerank, logger=Probe())
        ref = jev.evaluate(jds, rerank=rerank)
        assert ours["cmc"].shape == (100,)
        np.testing.assert_array_equal(ours["cmc"], np.asarray(ref["cmc"]))
        assert ours["mAP"] == pytest.approx(ref["mAP"], abs=1e-6)
    assert [kv["kind"] for kv in captured] == ["eval", "eval"]


@pytest.mark.parametrize("part", ["whole", "up", "down"])
def test_evaluator_single_part_matches_jax(part):
    ds, jds, fm, variables, tm = _evaluators()
    ours = api.Evaluator(tm, batch_size=16, part=part, device="cpu").evaluate(ds)
    ref = jax_api.Evaluator(fm, variables, batch_size=16, part=part).evaluate(jds)
    np.testing.assert_array_equal(ours["cmc"], np.asarray(ref["cmc"]))
    assert ours["mAP"] == pytest.approx(ref["mAP"], abs=1e-6)


def test_extract_features_runs_in_eval_mode_and_restores(rng):
    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=8).train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    images = rng.integers(0, 256, size=(4, 64, 32, 3), dtype=np.uint8)
    batches = [(images, np.zeros(4), np.zeros(4), np.ones(4, bool))]
    feats, _, _, fnames = api.extract_features(tm, batches, device="cpu")
    assert tm.training and fnames is None
    # Eval mode: unit-norm embeddings and untouched BN statistics.
    np.testing.assert_allclose(feats.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
