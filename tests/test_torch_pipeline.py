"""The port's main path as a whole against the JAX package (CPU):
features -> cluster_groups, and images -> features -> labels with weights
carried over from JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu import api as jax_api
from ssg_tpu import models as jax_models
from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.data.preprocessor import Preprocessor as JaxPreprocessor

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.data import Preprocessor, datasets
from ssg_tpu_torch.models.convert import from_jax_variables

KW = dict(k1=20, k2=6, lambda_value=0.1, rho=0.02, min_samples=4)


def _clustered_feats(rng, groups=3, n=150, f=48, ids=15):
    centers = rng.normal(size=(groups, ids, f))
    assign = rng.integers(0, ids, size=(groups, n))
    x = np.take_along_axis(centers, assign[..., None].repeat(f, -1), axis=1)
    x = x + 0.35 * rng.normal(size=(groups, n, f))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_cluster_groups_matches_jax(rng):
    feats = _clustered_feats(rng)
    ours = api.cluster_groups(feats, device="cpu", **KW)
    ref = jax_api.cluster_groups(jnp.asarray(feats), **KW)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[0].dtype == np.int32 and ours[0].shape == (3, 150)
    assert ours[1] == ref[1] and sum(ours[1]) > 0
    # eps is a mean over fp32 sums taken in another order.
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-5)


def test_cluster_matches_jax(rng):
    feats = _clustered_feats(rng, groups=1)[0]
    dist = jax_api.re_ranking(features=jnp.asarray(feats), k1=20, k2=6)
    ref = jax_api.cluster(dist, rho=0.02)
    ours = api.cluster(np.array(dist), rho=0.02, device="cpu")
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    assert ours[2] == pytest.approx(ref[2], rel=1e-6)
    fixed = api.cluster(np.array(dist), eps=ref[2], device="cpu")
    np.testing.assert_array_equal(fixed[0], ref[0])


def test_images_to_labels_with_carried_weights():
    # Tiny synthetic set, shallow model at the full 256x128 input.
    ds = datasets.create("market1501", scale="tiny", seed=1)
    items = (ds.train + ds.query)[:90]
    stage_sizes = (1, 1)
    fm = jax_models.SSGResNet(stage_sizes=stage_sizes, num_features=0, num_parts=3,
                              dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    variables = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 128, 3)), train=False)
    jfeats = jax_api.extract_features(
        fm, variables, JaxPreprocessor(jax_datasets.create("market1501", scale="tiny", seed=1),
                                       items=items, batch_size=32))[0]

    tm = models.create("resnet50", stage_sizes=stage_sizes, num_features=0).eval()
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    feats, pids, cams = api.extract_features(tm, Preprocessor(ds, items=items, batch_size=32),
                                             device="cpu")
    assert feats.shape == (3, 90, 512)  # padding rows of the tail batch dropped
    np.testing.assert_array_equal(pids, [p for _, p, _ in items])
    np.testing.assert_array_equal(cams, [c for _, _, c in items])
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=1e-5)

    ours = api.cluster_groups(feats, device="cpu", **KW)
    ref = jax_api.cluster_groups(jfeats, **KW)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    # Re-ranked distances are O(1) values, 1 - m / (2 - m); the random-weight
    # features here are near-duplicates, so eps (~1e-4) is a cancellation
    # residue with an absolute fp32 error of ~1e-7.
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            api.cluster_groups(np.zeros((1, 4, 2), np.float32))
    assert resolve_device("cpu").type == "cpu"
