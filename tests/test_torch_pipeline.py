"""The port's main path as a whole against the JAX package (CPU):
features -> cluster_groups, and images -> features -> labels with weights
carried over from JAX."""

import subprocess
import sys
from pathlib import Path

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
from ssg_tpu_torch.data import Preprocessor, datasets, transforms
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.utils import profiling

KW = dict(k1=20, k2=6, lambda_value=0.1, rho=0.02, min_samples=4)
ROOT = Path(__file__).resolve().parent.parent


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
    feats, pids, cams, fnames = api.extract_features(
        tm, Preprocessor(ds, items=items, batch_size=32), device="cpu")
    assert feats.shape == (3, 90, 512)  # padding rows of the tail batch dropped
    assert fnames == [f for f, _, _ in items]  # the fourth value, as JAX returns
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


def test_cpu_extract_stays_eager_and_matches_jax():
    # On the CPU no batch replays a graph and no graph state is kept: two
    # calls on the same weights (three batches, the last padded) count no
    # replay, give the same features, and equal JAX's.
    ds = datasets.create("market1501", scale="tiny", seed=2)
    items = ds.train[:40]
    fm = jax_models.SSGResNet(stage_sizes=(1, 1), num_features=0, num_parts=3,
                              dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    variables = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, 256, 128, 3)), train=False)
    jfeats = jax_api.extract_features(
        fm, variables, JaxPreprocessor(jax_datasets.create("market1501", scale="tiny", seed=2),
                                       items=items, batch_size=16))[0]
    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=0)
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    runs = []
    for _ in range(2):
        with profiling.record_spans():
            feats = api.extract_features(tm, Preprocessor(ds, items=items, batch_size=16),
                                         device="cpu")[0]
        rec = profiling.recorded()
        assert len(rec.of("extract.batch")) == 3
        assert rec.counters.get(api.EXTRACT_GRAPH_REPLAYS, 0) == 0
        runs.append(feats)
    assert tm not in api._eval_graphs
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].numpy(), np.asarray(jfeats), rtol=0, atol=1e-5)


def test_imagenet_stats_are_built_once_a_device():
    # The ImageNet statistics exactly as published, in fp32, the same tensors
    # on every call for a device, and what normalize divides by.
    mean, std = transforms._stats(torch.device("cpu"))
    assert mean.dtype == std.dtype == torch.float32 and mean.device.type == "cpu"
    assert torch.equal(mean, torch.tensor(transforms.IMAGENET_MEAN, dtype=torch.float32))
    assert torch.equal(std, torch.tensor(transforms.IMAGENET_STD, dtype=torch.float32))
    again = transforms._stats("cpu")
    assert again[0] is mean and again[1] is std
    x = torch.arange(2 * 3 * 2 * 3, dtype=torch.uint8).reshape(2, 3, 2, 3)
    assert torch.equal(transforms.normalize(x), (x.float() / 255.0 - mean) / std)


def test_tf32_is_off_once_the_package_is_imported():
    # A fresh interpreter with TF32 switched on, as cuDNN has it by default:
    # importing the port switches it off for cuBLAS and cuDNN.
    code = ("import torch; torch.backends.cuda.matmul.allow_tf32 = True; "
            "torch.backends.cudnn.allow_tf32 = True; import ssg_tpu_torch; "
            "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


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
