"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (``device="cpu"``) and the rest of a
run is driven at a tiny size, once for each fault a cell can have. A cell
on one card has no exchange between chips to leave out."""

from __future__ import annotations

import json

import pytest

from benchmark import faults, run
from benchmark.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,fault", [("tiny-train", "unchanged"),
                                        ("tiny-train", "half_batch"),
                                        ("tiny-extract", "alter"),
                                        ("tiny-cluster", "alter")])
def test_fault_is_not_correct(root, cell, fault, capsys):
    with faults.plant(fault):
        assert run.main(["--workload", cell, "--seed", "2147483651", "--seconds", "0.1"],
                        device="cpu", root=root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
