"""The port's root entry points on the CPU: ``bench_torch.py`` (``bench.py``'s
workload), ``ssg_tpu_torch.entry.entry()`` and ``dryrun_multichip(n)``
(``__graft_entry__.py``'s)."""

import ast
import json
from pathlib import Path

import numpy as np
import torch

import bench_torch
from ssg_tpu_torch import api
from ssg_tpu_torch.entry import _train_step_loss, dryrun_multichip, entry
from ssg_tpu_torch.parallel import make_mesh

ROOT = Path(__file__).resolve().parent.parent


def _bench_py_keys() -> list[str]:
    """The keys of ``bench.py``'s JSON line, in the order it builds them:
    the ``out = {...}`` literal, then each ``out["..."] = ...``."""
    keys = []
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" and isinstance(node.value, ast.Dict):
                keys += [k.value for k in node.value.keys]
            elif isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "out":
                keys.append(t.slice.value)
    return keys


def test_bench_torch_prints_bench_py_keys_in_order(capsys):
    want = _bench_py_keys()
    assert len(want) == 11
    out = bench_torch.run(n=16, batch=8, streaming_n=256, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == want and line == out
    assert line["metric"] == "ssg_extract_rerank_dbscan_wallclock_market_query_3368"
    assert line["device"] == "cpu" and len(line["clusters"]) == 3
    assert line["value"] > 0 and line["extract_seconds"] > 0


def test_entry_forward_equals_extract_features():
    fn, (model, images) = entry(device="cpu")
    assert images.shape == (8, 256, 128, 3) and images.dtype == torch.uint8
    emb = fn(model, images)
    assert emb.shape == (3, 8, 2048) and emb.dtype == torch.float32
    feats, _, _, _ = api.extract_features(
        model, [(images, np.zeros(8, np.int32), np.zeros(8, np.int32), np.ones(8, bool))],
        device="cpu")
    assert torch.equal(emb, feats)


def test_dryrun_multichip_two_ranks():
    r = dryrun_multichip(2)
    assert np.isfinite(r["loss"]) and r["points"] == 515
    assert min(r["agreement"]) >= 0.995 and r["agreement"][-1] == 1.0
    assert r["clusters_dense"] == r["clusters_streaming"] > 0


def test_dryrun_train_step_has_a_loss_with_two_identities():
    """The dry run's step at n = 2 holds one identity and its loss is 0; at
    a batch of 8 (two identities, as at n = 4) the same step has a finite,
    positive loss."""
    loss = _train_step_loss(make_mesh(1, device="cpu"), batch=8)
    assert np.isfinite(loss) and loss > 0
