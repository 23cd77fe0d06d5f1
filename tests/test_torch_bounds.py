"""The bound arithmetic of ``chip_smoke.py``, at the path size N = 3368.

A kernel's share of its bound is read against these numbers, so they are
pinned here on the CPU: the pairs a call needs (N(N+1)/2 when y is x), the
L1's two fp32 instructions a pair and element, the distance's products on
the fp32 FMA pipes or as three TF32 tensor-core products (3xTF32), and the
fp32 bottleneck blocks' products the same two ways.
``chip_smoke.py`` is loaded by its path from the repository root.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N = 3368
D = 2048  # the distance's feature width on the path


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,n,symmetric,expected", [
    (N, N, False, N * N), (N, N, True, 5_673_396), (1, 1, True, 1), (5, 5, True, 15),
    (5, 7, False, 35)])
def test_pairs(smoke, m, n, symmetric, expected):
    assert smoke.pairs(m, n, symmetric) == expected
    if symmetric:
        assert expected == m * (m + 1) // 2


@pytest.mark.parametrize("symmetric,ms", [(False, 2.284), (True, 1.142)])
def test_l1_bound(smoke, symmetric, ms):
    bound, by = smoke.l1_bound_ms(N, N, N, symmetric=symmetric)
    ops = 2.0 * smoke.pairs(N, N, symmetric) * N
    assert by == "operations"
    assert bound == pytest.approx(ops / smoke.FP32_NON_FMA_PER_S * 1e3, rel=1e-12)
    assert bound == pytest.approx(ms, abs=1e-3)


@pytest.mark.parametrize("symmetric,route,ms", [
    (False, "fma", 0.693), (True, "fma", 0.347), (True, "3xtf32", 0.141),
    (False, "3xtf32", 0.282)])
def test_distance_bound(smoke, symmetric, route, ms):
    bound, by = smoke.dist_bound_ms(N, N, D, symmetric=symmetric, route=route)
    flop = 2.0 * smoke.pairs(N, N, symmetric) * D
    expected = flop / 67e12 if route == "fma" else 3 * flop / 495e12
    assert by == "operations"
    assert bound == pytest.approx(expected * 1e3, rel=1e-12)
    assert bound == pytest.approx(ms, abs=1e-3)


def test_bounds_by_bytes(smoke):
    # One feature: nothing to compute, the output's bytes set the bound.
    bound, by = smoke.l1_bound_ms(N, N, 1, symmetric=True)
    assert by == "bytes"
    assert bound == pytest.approx(4.0 * (N + N * N) / smoke.HBM_BYTES_PER_S * 1e3)
    assert smoke.dist_bound_ms(N, N, 1, symmetric=True)[1] == "bytes"


def _fp32_block(c, cm, cout, ds=False):
    """Folded fp32 block weights on the meta device: shapes and bytes only."""
    shapes = [(c, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    shapes += [(c, cout), (cout,)] if ds else []
    return tuple(torch.empty(s, dtype=torch.float32, device="meta") for s in shapes)


# The fp32 bottleneck: every identity block at batch 128 does 17 Cm^2
# multiply-adds a pixel, 36.51 GFLOP, bound by operations in every layer:
# 0.2213 ms as three TF32 tensor-core products, 0.5449 ms on the FMA pipes;
# 12 blocks a batch 2.655 / 6.539 ms. Reading x and writing out in fp32
# takes 0.160 ms at layer1, the most of any layer.
@pytest.mark.parametrize("route,block_ms,batch_ms", [("3xtf32", 0.2213, 2.655),
                                                     ("fma", 0.5449, 6.539)])
def test_fp32_block_bound(smoke, route, block_ms, batch_ms):
    total = 0.0
    for name, h, w, c, cm, count in smoke.IDENTITY:
        shape = (128, h, w, c)
        blk = _fp32_block(c, cm, c)
        bound, by = smoke.blocks_bound_ms(shape, [blk], 1, route)
        ops = smoke.block_work(shape, blk, 1)[0]
        assert ops == pytest.approx(36.51e9, rel=1e-3)
        assert by == "operations"
        assert bound == pytest.approx(block_ms, abs=1e-4)
        total += count * bound
    assert total == pytest.approx(batch_ms, abs=1e-3)
    layer1 = smoke.IDENTITY[0]
    nbytes = 4.0 * 2 * 128 * layer1[1] * layer1[2] * layer1[3]
    assert nbytes / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.160, abs=1e-3)


def test_fp32_downsample_bound_by_operations(smoke):
    for name, h, w, c, cm, cout, s in smoke.DOWNSAMPLE:
        blk = _fp32_block(c, cm, cout, ds=True)
        assert smoke.blocks_bound_ms((128, h, w, c), [blk], s, "3xtf32")[1] == "operations"
