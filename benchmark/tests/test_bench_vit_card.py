"""The new cells' limits catch the precision below the configuration's and
a fault, at the cells' own size on the card: the fp8 control (the plain
reference with every linear's, the patch convolution's and attention's
operands rounded to e4m3, in the program's place) and half of each batch
left out fail ``vitb-train-duke``; the fp8 control fails
``r101-extract-duke``. The benchmark's own runs do not run it.

    python3 -m pytest benchmark/tests/test_bench_vit_card.py -m cuda
"""

from __future__ import annotations

import gc

import pytest

from benchmark import faults, harness
from benchmark.tests.tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the limits are judged at the cell's own size")
    return torch.device("cuda", 0)


def _output(cell, fault=None):
    import torch

    with faults.plant(fault):
        st = cell.kind.setup(cell)
        if cell.mix["kind"] == "extract":
            cell.kind.window(cell, st, 0.0)
        out = cell.kind.collect(cell, st)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vitb-train-duke", "r101-extract-duke"])
def test_control_fails(card, workload):
    cell = harness.Cell.load(ROOT, workload, 2147483654, card)
    ok, _ = harness.judge(cell.kind.control(cell, _output(cell)), cell.limits)
    assert not ok


@pytest.mark.cuda
def test_half_batch_fails(card):
    cell = harness.Cell.load(ROOT, "vitb-train-duke", 2147483655, card)
    readings, _ = cell.kind.check(cell, _output(cell, "half_batch"))
    ok, _ = harness.judge(readings, cell.limits)
    assert not ok
