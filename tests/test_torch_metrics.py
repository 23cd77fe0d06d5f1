"""Port parity of ``evaluation_metrics`` (``cmc`` with its full flag set,
``mean_ap``, ``accuracy``) against the JAX package and the numpy oracle on
the same inputs (CPU). Both sides sort stably, so tied distances rank in
gallery order alike: first-match CMC must be exact, the allshots histogram
may differ by the order of its fp32 sums. The single-gallery-shot draws
differ between ``jax.random`` and ``torch.Generator``, so that protocol is
held exactly where the draw is deterministic and in expectation elsewhere."""

import numpy as np
import pytest
import torch

from ssg_tpu.evaluation_metrics import accuracy as jax_accuracy
from ssg_tpu.evaluation_metrics import cmc as jax_cmc
from ssg_tpu.evaluation_metrics import mean_ap as jax_mean_ap
from ssg_tpu.oracle.ranking import cmc_np, mean_ap_np

from ssg_tpu_torch.evaluation_metrics import accuracy, cmc, mean_ap
from ssg_tpu_torch.loss import OIMLoss


def _protocol(rng, nq=40, ng=180, ids=25, cams=4, ties=False):
    q_ids = rng.integers(0, ids, nq)
    g_ids = rng.integers(0, ids, ng)
    q_cams = rng.integers(0, cams, nq)
    g_cams = rng.integers(0, cams, ng)
    if ties:  # quantised distances: many exact ties, broken by gallery order
        dist = (rng.integers(0, 6, (nq, ng)) / 4.0).astype(np.float32)
    else:
        dist = rng.random((nq, ng)).astype(np.float32)
        dist -= 0.3 * (q_ids[:, None] == g_ids[None, :])
    return dist, q_ids, g_ids, q_cams, g_cams


@pytest.mark.parametrize("topk", [5, 100, 150])
@pytest.mark.parametrize("first_match_break", [True, False])
@pytest.mark.parametrize("separate_camera_set", [False, True])
def test_cmc_matches_jax_and_oracle(separate_camera_set, first_match_break, topk):
    kw = dict(topk=topk, separate_camera_set=separate_camera_set,
              first_match_break=first_match_break)
    rng = np.random.default_rng(topk)
    for ties in (False, True):
        args = _protocol(rng, ties=ties)
        ours = cmc(*args, device="cpu", **kw)
        ref = jax_cmc(*args, **kw)
        assert ours.shape == ref.shape == (topk,) and ours.dtype == np.float32
        if first_match_break:
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        if not ties:  # the oracle's argsort is not stable
            np.testing.assert_allclose(ours, cmc_np(*args, **kw), rtol=0, atol=1e-6)


def test_mean_ap_matches_jax_and_oracle(rng):
    for ties in (False, True):
        args = _protocol(rng, ties=ties)
        ours = mean_ap(*args, device="cpu")
        assert ours == pytest.approx(jax_mean_ap(*args), rel=0, abs=1e-6)
        if not ties:
            assert ours == pytest.approx(mean_ap_np(*args), rel=0, abs=1e-6)


def _singleton_gallery(rng, n_ids=12, queries_per_id=2):
    """One valid gallery instance of each identity for every query."""
    g_ids = np.arange(n_ids)
    g_cams = np.ones(n_ids, int)
    q_ids = np.arange(n_ids).repeat(queries_per_id)
    q_cams = np.zeros_like(q_ids)
    dist = rng.normal(size=(q_ids.size, n_ids)).astype(np.float32)
    return dist, q_ids, g_ids, q_cams, g_cams


@pytest.mark.parametrize("first_match_break", [False, True])
@pytest.mark.parametrize("separate_camera_set", [False, True])
def test_single_gallery_shot_exact_when_the_draw_is_deterministic(rng, separate_camera_set,
                                                                  first_match_break):
    args = _singleton_gallery(rng)
    kw = dict(topk=10, single_gallery_shot=True, separate_camera_set=separate_camera_set,
              first_match_break=first_match_break)
    ours = cmc(*args, device="cpu", **kw)
    np.testing.assert_array_equal(ours, jax_cmc(*args, **kw))
    np.testing.assert_allclose(ours, cmc_np(*args, **kw), rtol=0, atol=1e-6)
    # The oracle's quirk: with first_match_break each of the 10 repeats adds
    # a full 1, so the curve is 10 x the allshots one.
    allshots = cmc(*args, device="cpu", **{**kw, "first_match_break": False})
    np.testing.assert_array_equal(ours, allshots * (10 if first_match_break else 1))


@pytest.mark.parametrize("first_match_break", [False, True])
def test_single_gallery_shot_in_expectation(first_match_break):
    """Identity 0 has two valid gallery instances, each drawn with
    probability 1/2 in each repeat; the exact expected curve is the mean of
    the two deterministic curves with one of them removed (oracle). The
    mean over 200 seeds must lie within 4 standard errors of it."""
    rng = np.random.default_rng(3)
    dist, q_ids, g_ids, q_cams, g_cams = _singleton_gallery(rng, n_ids=8, queries_per_id=3)
    g_ids = np.concatenate([g_ids, [0]])
    g_cams = np.concatenate([g_cams, [2]])
    dist = np.concatenate([dist, rng.normal(size=(dist.shape[0], 1)).astype(np.float32)], 1)
    kw = dict(topk=8, single_gallery_shot=True, first_match_break=first_match_break)
    exact = np.mean([cmc_np(dist[:, keep], q_ids, g_ids[keep], q_cams, g_cams[keep], **kw)
                     for keep in (np.arange(9) != 0, np.arange(9) != 8)], axis=0)
    draws = np.stack([cmc(dist, q_ids, g_ids, q_cams, g_cams, rng=np.random.default_rng(s),
                          device="cpu", **kw) for s in range(200)])
    se = draws.std(0, ddof=1) / np.sqrt(len(draws))
    assert np.all(np.abs(draws.mean(0) - exact) <= 4 * se + 1e-6), (draws.mean(0), exact, se)
    assert se.max() > 0  # the draw is random where identity 0 decides the rank
    # A different seed gives another draw; the same seed the same one.
    np.testing.assert_array_equal(
        cmc(dist, q_ids, g_ids, q_cams, g_cams, rng=np.random.default_rng(0), device="cpu", **kw),
        draws[0])


def test_no_valid_query_raises(rng):
    dist, _, g_ids, q_cams, g_cams = _protocol(rng, nq=5, ng=20, ids=4)
    q_ids = np.full(5, 99)  # no query identity in the gallery
    for kw in (dict(first_match_break=True), dict(first_match_break=False),
               dict(single_gallery_shot=True)):
        with pytest.raises(RuntimeError, match="No valid query"):
            cmc(dist, q_ids, g_ids, q_cams, g_cams, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="No valid query"):
        mean_ap(dist, q_ids, g_ids, q_cams, g_cams, device="cpu")


def test_accuracy_matches_jax_on_tied_logits(rng):
    # Integer logits in 0..2 over 10 classes: every row has ties, broken by
    # the lower index on both sides.
    logits = rng.integers(0, 3, size=(64, 10)).astype(np.float32)
    target = rng.integers(0, 10, size=64)
    ours = accuracy(logits, target, topk=(1, 5), device="cpu")
    assert ours == jax_accuracy(logits, target, topk=(1, 5))
    assert 0.0 < ours[0] < ours[1] < 1.0


@pytest.mark.parametrize("call", [
    lambda a: cmc(*a), lambda a: mean_ap(*a),
    lambda a: accuracy(np.eye(4, dtype=np.float32), np.arange(4)),
    lambda a: OIMLoss(8, 10),
], ids=["cmc", "mean_ap", "accuracy", "OIMLoss"])
def test_entry_points_default_to_the_card(rng, call):
    # device=None means cuda (_device.py); without a card that raises
    # instead of running on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        call(_protocol(rng, nq=5, ng=20))
