"""The control comes out not correct at the cell's own size: the plain
reference in the precision below the configuration's, put in the program's
place (fp8 convolutions for the bf16 models, TF32 for the fp32
clustering), fails a limit of the cell. Needs the card (the cell's size
and TF32 exist only there); the benchmark's own runs do not run it.

    python3 -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import gc

import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r50-train-duke", "r50-cluster-duke", "r50-extract-duke",
                                      "r101-train-duke"])
def test_control_fails(card, workload):
    import torch

    cell = harness.Cell.load(ROOT, workload, 2147483652, card)
    st = cell.kind.setup(cell)
    if cell.mix["kind"] != "train":
        cell.kind.window(cell, st, 0.0)
    out = cell.kind.collect(cell, st)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    ok, _ = harness.judge(cell.kind.control(cell, out), cell.limits)
    assert not ok
