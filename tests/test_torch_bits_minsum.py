"""Port parity of the streaming pipeline's operators: ``ops/bits.py``,
``ops/minsum.py`` and the sort-free ranks of ``ops/metrics.py``
(``rank_stats_hits`` / ``rank_stats_auto``), against the JAX package on
the same seeded inputs (CPU). Bits are exact; min-sums within fp32 ulps
(another summation order); the screening bound is sound by property."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from ssg_tpu.ops import bits as jax_bits
from ssg_tpu.ops import metrics as jax_metrics
from ssg_tpu.ops import minsum as jax_minsum

from ssg_tpu_torch.ops import bits, minsum
from ssg_tpu_torch.ops.metrics import rank_stats_auto, rank_stats_hits, rank_stats_masked


def _sparse_rows(rng, b, n, max_supp):
    """Random nonnegative rows with bounded support, row sums ~1."""
    v = np.zeros((b, n), np.float32)
    for i in range(b):
        k = rng.integers(1, max_supp + 1)
        idx = rng.choice(n, size=k, replace=False)
        w = rng.random(k).astype(np.float32) + 1e-3
        v[i, idx] = w / w.sum()
    return v


# ---- bits -----------------------------------------------------------------

def test_popcount_and_unpack_bit_exact_over_all_bytes():
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(bits.popcount(torch.from_numpy(every)).numpy(),
                                  np.asarray(jax_bits.popcount(jnp.asarray(every))))
    unpacked = bits.unpack_bits(torch.from_numpy(every[:, None]), 8)
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jax_bits.unpack_bits(jnp.asarray(every[:, None]), 8)))
    np.testing.assert_array_equal(unpacked.numpy(), np.unpackbits(every[:, None], axis=1,
                                                                   bitorder="little").astype(bool))
    np.testing.assert_array_equal(bits.pack_bits(unpacked).numpy()[:, 0], every)


@pytest.mark.parametrize("shape,p", [((5, 64), 0.3), ((3, 40), 0.5), ((2, 3, 16), 0.7),
                                     ((1, 8), 0.1), ((17, 256), 0.02)])
def test_pack_bits_matches_jax_byte_for_byte(shape, p):
    x = np.random.default_rng(sum(shape)).random(shape) < p
    got = bits.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.shape == (*shape[:-1], shape[-1] // 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_bits.pack_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), np.packbits(x, axis=-1, bitorder="little"))
    np.testing.assert_array_equal(bits.unpack_bits(got, shape[-1]).numpy(), x)
    counts = bits.popcount(got).sum(-1).numpy()
    np.testing.assert_array_equal(counts, x.sum(-1))


# ---- minsum ---------------------------------------------------------------

def test_compact_rows_matches_jax():
    v = _sparse_rows(np.random.default_rng(0), 16, 200, 12)
    idx, val = minsum.compact_rows(torch.from_numpy(v), 16)
    jidx, jval = map(np.asarray, jax_minsum.compact_rows(jnp.asarray(v), 16))
    np.testing.assert_array_equal(val.numpy(), jval)  # sorted values, descending
    for i in range(16):  # every nonzero captured (zero slots may name any index)
        want = {(j, v[i, j]) for j in np.nonzero(v[i])[0]}
        assert {(j, x) for j, x in zip(idx[i].tolist(), val[i].tolist()) if x > 0} == want
        assert {(j, x) for j, x in zip(jidx[i], jval[i]) if x > 0} == want


def _pair_tables(seed, b, q, n, s, rows_vary):
    rng = np.random.default_rng(seed)
    v = _sparse_rows(rng, 32, n, s)
    ti, tv = minsum.compact_rows(torch.from_numpy(v), s)
    rows = rng.integers(0, 32, size=(b, q) if rows_vary else (b,))
    cols = rng.integers(0, 32, size=(b, q))
    return v, ti, tv, rows, cols


@pytest.mark.parametrize("q", [6, 7, 1])
def test_sparse_minsum_matches_jax_and_dense(q):
    v, ti, tv, rows, cols = _pair_tables(1, 8, q, 160, 16, rows_vary=False)
    args = (ti[rows], tv[rows], ti[cols], tv[cols])
    got = minsum.sparse_minsum(*args, qblock=4).numpy()
    want = np.minimum(v[rows][:, None, :], v[cols]).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ref = np.asarray(jax_minsum.sparse_minsum(*(jnp.asarray(a.numpy()) for a in args), qblock=4))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("q", [8, 5, 13])
def test_sparse_minsum_pairs_matches_jax_and_dense(q):
    v, ti, tv, rows, cols = _pair_tables(3, 6, q, 120, 12, rows_vary=True)
    args = (ti[rows], tv[rows], ti[cols], tv[cols])
    got = minsum.sparse_minsum_pairs(*args, qblock=4).numpy()
    np.testing.assert_allclose(got, np.minimum(v[rows], v[cols]).sum(-1), rtol=1e-6, atol=1e-7)
    ref = np.asarray(jax_minsum.sparse_minsum_pairs(*(jnp.asarray(a.numpy()) for a in args),
                                                    qblock=4))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_sparse_minsum_does_not_depend_on_qblock():
    """The block size only bounds the (b, qb, S, S) transient: every slot's
    S x S sum is the same reduction in any block."""
    v, ti, tv, rows, cols = _pair_tables(5, 9, 23, 300, 24, rows_vary=True)
    args = (ti[rows], tv[rows], ti[cols], tv[cols])
    base = minsum.sparse_minsum_pairs(*args, qblock=1)
    for qb in (2, 5, 23, 64, None):
        assert torch.equal(minsum.sparse_minsum_pairs(*args, qblock=qb), base), qb
    row_args = (ti[rows[:, 0]], tv[rows[:, 0]], ti[cols], tv[cols])
    base = minsum.sparse_minsum(*row_args, qblock=1)
    for qb in (3, 23, None):
        assert torch.equal(minsum.sparse_minsum(*row_args, qblock=qb), base), qb


def test_bound_matches_jax_within_ulps():
    rng = np.random.default_rng(4)
    v = _sparse_rows(rng, 64, 256, 16)
    orig = rng.random((64, 64)).astype(np.float32)
    vt = torch.from_numpy(v)
    g = minsum.bound_product(minsum.support_mask(vt), vt)
    assert g.dtype == torch.float32
    fd_lb = minsum.fd_lower(minsum.minsum_upper(g), torch.from_numpy(orig), 0.1).numpy()
    vj = jnp.asarray(v)
    jg = jnp.dot(jax_minsum.support_mask(vj), vj.T.astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    ref = np.asarray(jax_minsum.fd_lower(jax_minsum.minsum_upper(jg), jnp.asarray(orig), 0.1))
    np.testing.assert_allclose(fd_lb, ref, rtol=2e-7, atol=1e-7)


def _exact_fd(v, orig, lam):
    ms = np.minimum(v[:, None, :], v[None, :, :]).sum(-1, dtype=np.float32)
    jac = 1.0 - ms / (2.0 - ms)
    return np.maximum(jac * (1 - lam) + orig * lam, 0.0)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(4, 48), width=st.integers(16, 400),
       supp=st.integers(1, 40), lam=st.sampled_from([0.0, 0.1, 0.3]),
       dup=st.booleans())
def test_bound_is_sound_property(seed, n, width, supp, lam, dup):
    """fd_lower(minsum_upper(bf16 mask product)) <= the exact fd for every
    pair, near-duplicate rows included (ms ~ 1, jaccard slightly negative in
    fp: the reason the clamp is at the fd level)."""
    rng = np.random.default_rng(seed)
    v = _sparse_rows(rng, n, width, min(supp, width))
    if dup and n >= 4:
        v[1] = v[0]
        v[3] = v[2] * np.float32(1 + 1e-7)
    orig = rng.random((n, n)).astype(np.float32)
    vt = torch.from_numpy(v)
    fd_lb = minsum.fd_lower(minsum.minsum_upper(minsum.bound_product(minsum.support_mask(vt), vt)),
                            torch.from_numpy(orig), lam).numpy()
    fd = _exact_fd(v, orig, lam)
    assert (fd_lb <= fd + 1e-12).all(), (fd_lb - fd).max()


def test_bound_is_usefully_tight():
    """On random sparse rows (little overlap) a mid-range radius prunes
    nearly every pair: the point of the screen."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(_sparse_rows(rng, 128, 512, 16))
    orig = torch.from_numpy(rng.random((128, 128)).astype(np.float32) * 0.5 + 0.5)
    g = minsum.bound_product(minsum.support_mask(v), v)
    assert float((minsum.fd_lower(minsum.minsum_upper(g), orig, 0.1) > 0.6).float().mean()) > 0.9


# ---- sort-free ranks --------------------------------------------------------

def _protocol(seed, nq, ng, ids, cams, ties):
    rng = np.random.default_rng(seed)
    q_ids, g_ids = rng.integers(0, ids, nq), rng.integers(0, ids, ng)
    q_cams, g_cams = rng.integers(0, cams, nq), rng.integers(0, cams, ng)
    dist = ((rng.integers(0, 5, (nq, ng)) / 4.0) if ties else rng.random((nq, ng)))
    row_mask = rng.random(nq) < 0.8
    col_mask = rng.random(ng) < 0.9
    return [np.asarray(a) for a in (dist.astype(np.float32), q_ids, g_ids, q_cams, g_cams,
                                    row_mask, col_mask)]


@pytest.mark.parametrize("seed,ties,hit_cap,masks", [
    (0, False, 64, False), (1, True, 64, True), (2, True, 3, False), (3, False, 2, True),
    (4, False, 64, True)])
def test_rank_stats_hits_and_auto_match_jax(seed, ties, hit_cap, masks):
    """hit_cap 2-3 overflows (ids of 6 give ~20 hits a row): the auto form
    takes the argsort fallback; 64 does not."""
    args = _protocol(seed, 24, 120, 6, 3, ties)
    if not masks:
        args = args[:5] + [None, None]
    t = [None if a is None else torch.from_numpy(a) for a in args]
    j = [None if a is None else jnp.asarray(a) for a in args]
    a, cm, v, ovf = rank_stats_hits(*t, hit_cap=hit_cap)
    ja, jcm, jv, jovf = jax_metrics.rank_stats_hits(*j, hit_cap=hit_cap)
    assert bool(ovf) == bool(jovf) == (hit_cap < 64)
    if not bool(ovf):
        assert float(a) == pytest.approx(float(ja), abs=1e-6)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
        assert int(v) == int(jv)
    a, cm, v = rank_stats_auto(*t, hit_cap=hit_cap)
    ja, jcm, jv = jax_metrics.rank_stats_auto(*j, hit_cap=hit_cap)
    assert float(a) == pytest.approx(float(ja), abs=1e-6)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert int(v) == int(jv)
    ma, mcm, mv = rank_stats_masked(*t)
    assert float(a) == pytest.approx(float(ma), abs=1e-6)
    np.testing.assert_array_equal(cm.numpy(), mcm.numpy())
    assert int(v) == int(mv)


def test_nan_distances_rank_last_in_both_forms():
    """A NaN distance ranks after every number, +inf included, as the stable
    argsort orders it. JAX's compare-count form ranks a NaN hit first (every
    comparison with NaN is false); the port does not copy that."""
    dist, q_ids, g_ids, q_cams, g_cams = _protocol(7, 12, 60, 4, 3, False)[:5]
    dist[0, np.flatnonzero(g_ids == q_ids[0])[:2]] = np.nan
    dist[1, :5] = np.inf
    dist[1, np.flatnonzero(g_ids == q_ids[1])[:1]] = np.nan
    dist[2, :] = np.nan
    t = [torch.from_numpy(a) for a in (dist, q_ids, g_ids, q_cams, g_cams)]
    a, cm, v, ovf = rank_stats_hits(*t)
    ma, mcm, mv = rank_stats_masked(*t)
    assert not bool(ovf)
    assert float(a) == pytest.approx(float(ma), abs=1e-6)
    np.testing.assert_array_equal(cm.numpy(), mcm.numpy())
    assert int(v) == int(mv)
    ja = jax_metrics.rank_stats_hits(*map(jnp.asarray, (dist, q_ids, g_ids, q_cams, g_cams)))[0]
    assert float(ja) > float(a) + 1e-3  # the reference defect: NaN hits rank 1
