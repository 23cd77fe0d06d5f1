"""The port's metric learning and feature extraction against the JAX
package, on the CPU: KISSME (``M_``, ``L_ L_^T`` and its distances; ``L_``
itself is fixed only up to the sign of each column, which ``eigh`` leaves
free), ``Euclidean``, ``get_metric``, ``DistanceMetric.train``,
``extract_cnn_feature`` and a ``FeatureDatabase`` round trip."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssg_tpu.data.preprocessor import Preprocessor as JaxPreprocessor
from ssg_tpu.dist_metric import DistanceMetric as JaxDistanceMetric
from ssg_tpu.feature_extraction import extract_cnn_feature as jax_extract_cnn_feature
from ssg_tpu.metric_learning import KISSME as JaxKISSME
from ssg_tpu.metric_learning.kissme import _pairs as jax_pairs

from ssg_tpu_torch import api
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.dist_metric import DistanceMetric
from ssg_tpu_torch.feature_extraction import FeatureDatabase, extract_cnn_feature
from ssg_tpu_torch.metric_learning import KISSME, Euclidean, get_metric
from ssg_tpu_torch.metric_learning.kissme import _pairs
from test_torch_train import _jax_pair

# M is the difference of two inverses of fp32 covariances, each side
# inverting with its own LAPACK in its own order: on these well-conditioned
# 32-d covariances (500 samples) the two agree to fp32 rounding times the
# condition number, held at 1e-4 of the largest entry of M (of the largest
# distance for distances).
KISSME_REL = 1e-4


def _check_kissme(ours, ref, X):
    m, m_ref = ours.M_.numpy(), np.asarray(ref.M_)
    scale = np.abs(m_ref).max()
    np.testing.assert_allclose(m, m_ref, rtol=0, atol=KISSME_REL * scale)
    lt = (ours.L_ @ ours.L_.T).numpy()
    np.testing.assert_allclose(lt, m_ref, rtol=0, atol=KISSME_REL * scale)
    d, d_ref = ours.distance(X).numpy(), np.asarray(ref.distance(X))
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=KISSME_REL * np.abs(d_ref).max())
    d = ours.distance(X[:7], X[7:20]).numpy()
    d_ref = np.asarray(ref.distance(X[:7], X[7:20]))
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=KISSME_REL * np.abs(d_ref).max())


@pytest.mark.parametrize("max_pairs", [50_000, 300])
def test_kissme_matches_jax(rng, max_pairs):
    """All within-class pairs, and the cap (300 drawn of ~6,000)."""
    y = rng.integers(0, 25, 500)
    X = (rng.normal(size=(500, 32)) + rng.normal(size=(25, 32))[y]).astype(np.float32)
    a, b = _pairs(y, np.random.default_rng(3), max_pairs)
    ja, jb = jax_pairs(y, np.random.default_rng(3), max_pairs)
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    ours = KISSME(max_pairs=max_pairs, seed=3).fit(X, y, device="cpu")
    ref = JaxKISSME(max_pairs=max_pairs, seed=3).fit(X, y)
    assert ours.M_.dtype == torch.float32 and ours.M_.shape == (32, 32)
    _check_kissme(ours, ref, X)
    np.testing.assert_allclose(ours.transform(X).numpy() ** 2 @ np.ones(32),
                               (np.asarray(ref.transform(X)) ** 2).sum(1), rtol=1e-4)


def test_kissme_refusals():
    with pytest.raises(ValueError, match="2 samples"):
        KISSME().fit(np.zeros((3, 4), np.float32), np.arange(3), device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        KISSME().transform(np.zeros((3, 4), np.float32))


def test_euclidean_and_get_metric():
    X = np.arange(12, dtype=np.float32).reshape(3, 4)
    e = get_metric("euclidean")
    assert isinstance(e, Euclidean) and e.fit(X, None) is e
    np.testing.assert_array_equal(e.transform(X).numpy(), X)
    k = get_metric("kissme", max_pairs=7, seed=2)
    assert isinstance(k, KISSME) and (k.max_pairs, k.seed) == (7, 2)
    with pytest.raises(KeyError, match="known"):
        get_metric("mahalanobis")


class _Blocks:
    """14 identities x 8 images of 256x128: a coarse colour pattern per
    identity plus noise per image, so the whole-body features of a random
    model vary between identities and within them."""

    train = [(f"{i:08d}_00_{k:04d}.jpg", i, 0) for i in range(14) for k in range(8)]

    def render(self, fnames):
        out = []
        for f in fnames:
            pid, k = int(f[:8]), int(f[12:16])
            base = np.random.default_rng(pid).integers(0, 256, (8, 4, 3)).repeat(32, 0).repeat(
                32, 1)
            noise = np.random.default_rng(1000 + 8 * pid + k).integers(-40, 41, (256, 128, 3))
            out.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        return np.stack(out)


def test_distance_metric_train_matches_jax(rng):
    """``DistanceMetric('kissme').train`` fits on the whole-body branch of
    the extract (the same fit as ``KISSME().fit`` on ``feats[0]``), on 16-d
    features of a shallow model holding the same weights in both packages;
    ``M_`` within ``KISSME_REL`` of JAX's."""
    fm, variables, tm = _jax_pair(rng, num_features=16)
    ours = DistanceMetric("kissme").train(tm, Preprocessor(_Blocks(), batch_size=32),
                                          device="cpu")
    ref = JaxDistanceMetric("kissme").train(fm, variables, JaxPreprocessor(_Blocks(),
                                                                          batch_size=32))
    feats, pids, _, _ = api.extract_features(tm, Preprocessor(_Blocks(), batch_size=32),
                                             device="cpu")
    assert torch.equal(ours.metric.M_, KISSME().fit(feats[0], pids, device="cpu").M_)
    m, m_ref = ours.metric.M_.numpy(), np.asarray(ref.metric.M_)
    np.testing.assert_allclose(m, m_ref, rtol=0, atol=KISSME_REL * np.abs(m_ref).max())
    x = feats[0][:5]
    assert torch.equal(ours.transform(x), x @ ours.metric.L_)
    euclid = DistanceMetric("euclidean")
    assert euclid.train(tm, Preprocessor(_Blocks(), batch_size=32), device="cpu") is euclid
    assert torch.equal(euclid.transform(x), x)


def test_extract_cnn_feature(rng):
    fm, variables, tm = _jax_pair(rng, num_features=16)
    images = rng.integers(0, 256, size=(6, 64, 32, 3), dtype=np.uint8)
    tm.train()
    got = extract_cnn_feature(tm, images, device="cpu")
    assert tm.training  # the mode is restored
    assert got.shape == (3, 6, 16)
    ref = api.extract_features(tm, [(images, np.zeros(6), np.zeros(6), np.ones(6, bool))],
                               device="cpu")[0]
    assert torch.equal(got, ref)
    want = np.asarray(jax_extract_cnn_feature(fm, variables, jnp.asarray(images)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert extract_cnn_feature(tm, torch.from_numpy(images), device="cpu").equal(got)
    with pytest.raises(TypeError, match="uint8"):
        extract_cnn_feature(tm, images.astype(np.float32), device="cpu")


def test_feature_database_roundtrip(tmp_path, rng):
    pytest.importorskip("h5py")
    path = str(tmp_path / "feats.h5")
    rows = {f"{i:08d}_00_0000.jpg": rng.normal(size=(8,)) for i in range(3)}
    with FeatureDatabase(path, "w") as db:
        for key, value in rows.items():
            db[key] = torch.from_numpy(value)
        db["00000000_00_0000.jpg"] = np.ones(8)  # overwrites
    with FeatureDatabase(path) as db:
        assert len(db) == 3 and sorted(db.keys()) == sorted(rows)
        assert "00000001_00_0000.jpg" in db and "absent" not in db
        np.testing.assert_array_equal(db["00000000_00_0000.jpg"], np.ones(8, np.float32))
        got = db["00000002_00_0000.jpg"]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, rows["00000002_00_0000.jpg"].astype(np.float32))
