"""The reader of ``graphed_pct.extract``: the program's
``extract.graph_replays`` counter over its ``extract.batch`` spans, x 100;
silent where the program recorded no span, has no spans at all, or has no
graphed extract (an older program); and 0 on the CPU, whose extract runs
eager."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

from benchmark.tests.test_bench_spans import INFO, _reader
from benchmark.tests.test_bench_spans import _recorded as _spans_recorded
from ssg_tpu_torch.utils import profiling
from ssg_tpu_torch.utils.profiling import Recorded

NAME = "graphed_pct.extract"


def _recorded():
    """The span readers' recording (three extract batches among train and
    cluster spans), two of its extract batches replayed."""
    rec = _spans_recorded()
    return Recorded(rec.spans, {**rec.counters, "extract.graph_replays": 2}, rec.dropped)


def test_reader_divides_replays_by_batches(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", _recorded)
    assert _reader(NAME).read(INFO) == pytest.approx(200.0 / 3, rel=1e-9)


@pytest.mark.parametrize("recorded", [lambda: None, lambda: Recorded([], {}, 0)],
                         ids=["no-recording", "no-spans"])
def test_reader_is_silent_without_batches(monkeypatch, recorded):
    monkeypatch.setattr(profiling, "recorded", recorded)
    assert _reader(NAME).read(INFO) is None


def test_reader_is_silent_without_spans_module(monkeypatch):
    # A program without spans (an older checkout): nothing to import.
    monkeypatch.setitem(sys.modules, "ssg_tpu_torch.utils.profiling",
                        types.ModuleType("ssg_tpu_torch.utils.profiling"))
    assert _reader(NAME).read(INFO) is None


def test_reader_is_silent_without_the_counter(monkeypatch):
    # A program whose extract has no graph (an older checkout): its api
    # names no counter, so the reader reads nothing, even among spans.
    monkeypatch.setattr(profiling, "recorded", _recorded)
    monkeypatch.setitem(sys.modules, "ssg_tpu_torch.api", types.ModuleType("ssg_tpu_torch.api"))
    assert _reader(NAME).read(INFO) is None


def test_reader_on_the_programs_own_cpu_extract():
    """The program's extract on the CPU under ``record_spans`` runs eager:
    the reader reads 0."""
    from ssg_tpu_torch import api, models

    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    images = (np.random.default_rng(0).random((4, 64, 32, 3)) * 255).astype(np.uint8)
    with profiling.record_spans():
        api.extract_features(model, [(images, np.arange(4), np.zeros(4), np.ones(4, bool))] * 2,
                             device="cpu")
    assert _reader(NAME).read(INFO) == 0.0
