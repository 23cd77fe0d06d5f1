"""The benchmark's own arithmetic: FLOPs, the L1 work count, the trace
reduction, and the traffic generators' shapes and seeding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.frozen import flops, l1work, traceview
from benchmark.frozen.features import clustered_features, identities
from benchmark.frozen.render import render_pool
from benchmark.frozen.sampler import epoch_batches, index_lists
from benchmark.reference.cluster import min_sums

R50 = {"height": 256, "width": 128, "stage_sizes": [3, 4, 6, 3], "last_stride": 2,
       "num_parts": 3}


@pytest.mark.parametrize("stages,gflop", [([3, 4, 6, 3], 5.338), ([3, 4, 23, 3], 10.187)])
def test_forward_flops(stages, gflop):
    assert flops.forward_flops({**R50, "stage_sizes": stages}) / 1e9 == pytest.approx(gflop,
                                                                                       abs=5e-4)
    assert flops.train_step_flops({**R50, "stage_sizes": stages}, 64) == pytest.approx(
        3 * 64 * gflop * 1e9, rel=1e-4)


def test_forward_flops_against_the_model_shapes():
    from ssg_tpu_torch.models.resnet import SSGResNet

    total = 0.0

    def hook(mod, args, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    model = SSGResNet(stage_sizes=(2, 1, 1, 2), num_features=0)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.zeros(1, 96, 48, 3))
    cfg = {**R50, "stage_sizes": [2, 1, 1, 2], "height": 96, "width": 48}
    assert flops.forward_flops(cfg) == pytest.approx(total, rel=1e-12)


def test_l1_work_against_brute_force():
    g = torch.Generator().manual_seed(0)
    n = 40
    v = torch.rand((n, n), generator=g) * (torch.rand((n, n), generator=g) < 0.2)
    pairs = sum(int((v[i] > 0).logical_and(v[j] > 0).sum())
                for i in range(n) for j in range(i + 1, n))
    ops, nbytes = l1work.work((v > 0).sum(0), n)
    assert ops == 2.0 * pairs + 3.0 * n * (n - 1) / 2
    assert nbytes == 8.0 * int((v > 0).sum()) + 4.0 * n * n
    m, counts = min_sums(v, max_pairs=50)
    assert torch.equal(counts, (v > 0).sum(0))
    brute = torch.minimum(v[:, None, :], v[None]).sum(-1)
    assert torch.allclose(m, brute, atol=1e-6)
    assert l1work.bound_s(counts, n) > 0


def _trace():
    sync = {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 55,
            "dur": 10, "pid": 1, "tid": 1}
    k = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 20, "dur": 20, "pid": 0, "tid": 7},
         {"ph": "X", "cat": "kernel", "name": "b", "ts": 30, "dur": 20, "pid": 0, "tid": 7},
         {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10, "pid": 0,
          "tid": 7},
         {"ph": "X", "cat": "kernel", "name": "a", "ts": 150, "dur": 5, "pid": 0, "tid": 7}]
    return [sync] + k


def test_trace_reduction():
    r = traceview.reduce_slice(_trace(), 200e-6)
    assert r["window_s"] == 200e-6
    assert r["busy_s"] == pytest.approx(45e-6)  # [20, 50), [70, 80) and [150, 155)
    assert r["device_events"] == 4
    assert r["by_name"] == pytest.approx({"a": 25e-6, "b": 20e-6, "copy": 10e-6})
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["(host between calls)"] == pytest.approx(70e-6)
    assert gaps[traceview.OUTSIDE] == pytest.approx(65e-6)
    assert traceview.reduce_slice(_trace()[:1], 1.0) is None
    # A wall time shorter than the device's busy time is not hidden.
    assert traceview.reduce_slice(_trace(), 30e-6)["busy_s"] == pytest.approx(45e-6)


def test_features_seeded():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        a = identities(g, 500, 30, 0.8, "cpu")
        return a, clustered_features(g, a, 30, 64, 8)

    (a1, f1), (a2, f2), (a3, _) = draw(1), draw(1), draw(2)
    assert torch.equal(a1, a2) and torch.equal(f1, f2) and not torch.equal(a1, a3)
    assert bool((a1[1:] >= a1[:-1]).all()) and int(a1.max()) < 30
    assert f1.shape == (500, 64)
    assert torch.allclose(f1.norm(dim=1), torch.ones(500), atol=1e-5)


def test_render_seeded():
    pids = torch.tensor([0, 1, 1, 2, 3])
    one, cams = render_pool(torch.Generator().manual_seed(5), pids, 4, 3, 32, 16, chunk=2)
    two, _ = render_pool(torch.Generator().manual_seed(5), pids, 4, 3, 32, 16, chunk=2)
    out = torch.empty_like(one)
    render_pool(torch.Generator().manual_seed(5), pids, 4, 3, 32, 16, chunk=2, out=out)
    assert one.shape == (5, 32, 16, 3) and one.dtype == torch.uint8
    assert torch.equal(one, two) and torch.equal(one, out)
    assert cams.shape == (5,) and int(cams.max()) < 3
    other, _ = render_pool(torch.Generator().manual_seed(6), pids, 4, 3, 32, 16, chunk=2)
    assert not torch.equal(one, other)


def test_pk_batches():
    pids = np.repeat(np.arange(10), [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    lists = index_lists(pids)
    assert [len(x) for x in lists] == list(range(1, 11))
    batches = epoch_batches(lists, 4, 8, seed=3)
    assert len(batches) == 10 * 4 // 8
    for b in batches:
        ids = pids[b].reshape(2, 4)
        assert (ids == ids[:, :1]).all() and ids[0, 0] != ids[1, 0]
    again = epoch_batches(lists, 4, 8, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(batches, again))


def _reader(name):
    from benchmark.harness import load_module
    from benchmark.tests.tiny import ROOT

    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", "reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,counts,expect", [
    ("idle_pct.train", {}, 100.0 * (1 - 45 / 200)),
    ("launches_per_step.train", {"steps": 2}, 2.0),
    ("mfu.train", {"flops": 4e6}, 100.0 * 4e6 / 45e-6 / 989e12),
    ("mfu.extract", {"flops": 4e6}, 100.0 * 4e6 / 45e-6 / 989e12),
    ("mfu.cluster", {"passes": 1, "gram_flops": 6.7e6, "l1_col_counts": [torch.tensor([2, 1])]},
     100.0 * (1e-7 + l1work.bound_s([2, 1], 2)) / 45e-6),
    ("l1_roofline", {"l1_col_counts": [torch.tensor([2, 1])]}, None),
    ("mfu.train", {}, None),
])
def test_metric_readers(name, counts, expect):
    """Each reader on a reduced slice of 200 us, 45 us of it busy; one that
    finds nothing to read (no kernel of its name, no count) is silent."""
    info = {"trace": traceview.reduce_slice(_trace(), 200e-6), "counts": counts}
    value = _reader(name).read(info)
    assert value == (None if expect is None else pytest.approx(expect, rel=1e-12))
