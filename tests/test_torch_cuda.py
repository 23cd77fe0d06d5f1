"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed, without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ssg_tpu_torch import api, resolve_device
from ssg_tpu_torch.ops import l1 as l1_mod
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return resolve_device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


# Ragged against the kernel's 64x64 output tile and 32-wide K slab.
@pytest.mark.parametrize("m,n,d", [(70, 33, 150), (5, 7, 3), (129, 64, 65), (1, 1, 1),
                                   (1000, 333, 777)])
def test_l1_kernel_matches_ref(gen, cuda, m, n, d):
    x = torch.from_numpy(gen.normal(size=(m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = l1_mod.launches
    out = l1_distance(x, y)
    torch.cuda.synchronize()
    assert l1_mod.launches == before + 1
    ref = l1_distance_ref(x, y)
    # fp32 sums in another order: 1e-5 of the row-sum scale.
    scale = float(x.abs().sum(1).max() + y.abs().sum(1).max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale


def test_l1_kernel_rejects_bad_input(cuda):
    x = torch.ones((8, 4), device=cuda)
    with pytest.raises(ValueError):
        l1_distance(x.T, x.T)  # not contiguous
    with pytest.raises(ValueError):
        l1_distance(x.double())
    with pytest.raises(ValueError):
        l1_distance(x, torch.ones((8, 5), device=cuda))


def test_cluster_groups_card_matches_cpu(gen, cuda):
    centers = gen.normal(size=(20, 64)) * 2.0
    pts = centers[np.repeat(np.arange(20), 10)] + gen.normal(size=(200, 64))
    f = np.stack([pts, pts[::-1]]).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    kw = dict(k1=20, k2=6, lambda_value=0.1, rho=0.02, min_samples=4)
    lc, nc, ec = api.cluster_groups(f, device="cpu", **kw)
    before = l1_mod.launches
    lg, ng, eg = api.cluster_groups(f, device=cuda, **kw)
    assert l1_mod.launches == before + 2
    np.testing.assert_array_equal(lg, lc)
    assert ng == nc
    np.testing.assert_allclose(eg, ec, rtol=1e-5)
