"""The per-layer readers of the program's spans and counters
(``ssg_tpu_torch.utils.profiling.recorded()``): each divides by the units
it finds among the spans, and is silent where the program recorded no
span, gave no stream time, or has no spans at all (an older program)."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

from benchmark.harness import load_module
from benchmark.tests.tiny import ROOT
from ssg_tpu_torch.utils import profiling
from ssg_tpu_torch.utils.profiling import Recorded, Span

TRAIN = ("feed_wait_ms.train", "forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train", "drain_ms.train")
CLUSTER = ("rerank_ms.cluster", "eps_ms.cluster", "dbscan_ms.cluster", "closure_rounds.cluster")
READERS = TRAIN + CLUSTER + ("forward_host_ms.extract",)


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       "spans_reader_" + name.replace(".", "_"))


def _span(name, i, ms, key=0, device_ms=None):
    start = 1_000_000_000 * (i + 1)
    return Span(name, i, None, key, 1, start, start + round(ms * 1e6), device_ms)


def _recorded():
    """Two train steps with a drain after the second; two cluster groups
    (stream ms 30 + 50 of re-ranking, 2 + 4 of eps, 100 + 140 of DBSCAN,
    17 closure rounds); three extract batches of 4, 5 and 6 ms."""
    rows = []
    for k in range(2):
        rows += [("train.feed_wait", 0.5 + k, k, None), ("train.upload", 0.25, k, None),
                 ("train.step", 40.0, k, None), ("train.forward", 12.0 + k, k, None),
                 ("train.backward", 20.0, k, None), ("train.optimizer", 3.0 + 2 * k, k, None)]
    rows.append(("train.drain", 9.0, 1, None))
    for g, (rr, eps, db) in enumerate([(30.0, 2.0, 100.0), (50.0, 4.0, 140.0)]):
        rows += [("cluster.rerank", 60.0, g, rr), ("cluster.eps", 3.0, g, eps),
                 ("cluster.dbscan", 200.0, g, db)]
    rows += [("extract.batch", ms, b, None) for b, ms in enumerate([4.0, 5.0, 6.0])]
    spans = [_span(name, i, ms, key, dev) for i, (name, ms, key, dev) in enumerate(rows)]
    return Recorded(spans, {"dbscan.closure_rounds": 17}, 0)


INFO = {"trace": None, "counts": {}}


@pytest.mark.parametrize("name,expect", [
    ("feed_wait_ms.train", (0.5 + 1.5) / 2), ("forward_host_ms.train", (12 + 13) / 2),
    ("backward_host_ms.train", 20.0), ("optimizer_host_ms.train", (3 + 5) / 2),
    ("drain_ms.train", 9.0 / 2), ("rerank_ms.cluster", 40.0), ("eps_ms.cluster", 3.0),
    ("dbscan_ms.cluster", 120.0), ("closure_rounds.cluster", 8.5),
    ("forward_host_ms.extract", 5.0),
])
def test_readers_divide_by_their_units(monkeypatch, name, expect):
    monkeypatch.setattr(profiling, "recorded", _recorded)
    assert _reader(name).read(INFO) == pytest.approx(expect, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_spans(monkeypatch, name):
    reader = _reader(name)
    monkeypatch.setattr(profiling, "recorded", lambda: None)
    assert reader.read(INFO) is None
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}, 0))
    assert reader.read(INFO) is None
    # A program without spans (an older checkout): nothing to import.
    monkeypatch.setitem(sys.modules, "ssg_tpu_torch.utils.profiling",
                        types.ModuleType("ssg_tpu_torch.utils.profiling"))
    assert reader.read(INFO) is None


def test_stream_readers_are_silent_without_events(monkeypatch):
    rec = _recorded()
    rec.spans[-4] = rec.spans[-4]._replace(device_ms=None)  # the last group's DBSCAN
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert _reader("dbscan_ms.cluster").read(INFO) is None
    assert _reader("rerank_ms.cluster").read(INFO) == pytest.approx(40.0)


def test_readers_on_the_programs_own_spans():
    """The program's train loop, clustering and extract on the CPU under
    ``record_spans``: every host reader reads, the stream readers are
    silent (no card, no events), and the closure rounds are whole."""
    from ssg_tpu_torch import api, models
    from ssg_tpu_torch.train.schedule import make_optimizer
    from ssg_tpu_torch.train.trainer import Trainer, make_train_step

    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 1e-3)
    trainer = Trainer(make_train_step(model, opt, num_parts=3, height=32, width=16), opt,
                      print_freq=2, device="cpu")
    rng = np.random.default_rng(0)
    batches = [((rng.random((8, 32, 16, 3)) * 255).astype(np.uint8),
                np.tile(np.repeat(np.arange(2), 4)[None], (3, 1))) for _ in range(3)]
    with profiling.record_spans():
        trainer.train(0, iter(batches), torch.Generator().manual_seed(1))
    for name in TRAIN:
        assert _reader(name).read(INFO) > 0, name

    g = torch.Generator().manual_seed(0)
    feats = torch.randn((2, 120, 16), generator=g)
    with profiling.record_spans():
        api.cluster_groups(feats / feats.norm(dim=2, keepdim=True), k1=8, k2=3, rho=0.03,
                           min_samples=2, device="cpu")
    rounds = _reader("closure_rounds.cluster").read(INFO)
    assert rounds >= 1 and 2 * rounds == int(2 * rounds)
    for name in CLUSTER[:3]:
        assert _reader(name).read(INFO) is None

    images = (rng.random((4, 64, 32, 3)) * 255).astype(np.uint8)
    with profiling.record_spans():
        api.extract_features(model, [(images, np.arange(4), np.zeros(4), np.ones(4, bool))] * 2,
                             device="cpu")
    assert _reader("forward_host_ms.extract").read(INFO) > 0
