"""A cell, a configuration, a traffic mix and a per-layer metric are added
from new files and entries alone, with no edit to a file that exists."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, run
from benchmark.tests.tiny import BENCH, make_root

EXTRA = '''
def read(info):
    return 100.0 * info["counts"]["images"] / max(info["counts"]["images"], 1)
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), extra_metric=EXTRA)


def test_new_files_only(root):
    here = root / "benchmark"
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (here / path.relative_to(BENCH)).read_bytes() == path.read_bytes()


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-extract", "tiny-cluster"])
def test_new_cell_runs(root, cell, capsys):
    assert run.main(["--workload", cell, "--seed", "2147483650", "--seconds", "0.2"],
                    device="cpu", root=root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


def test_new_metric_found(root):
    cell = harness.Cell.load(root, "tiny-extract", 1)
    names = [m["name"] for m in cell.per_layer()]
    assert "tiny_extra" in names and "mfu.extract" in names
    assert "mfu.train" not in names
    reader = cell.metric_reader("tiny_extra")
    assert reader.read({"trace": None, "counts": {"images": 5}}) == 100.0


def test_cells_of_the_benchmark():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.Cell.load(BENCH.parent, w["name"], 1)
        assert cell.kind.__name__.startswith("bench_kind_")
        assert set(cell.limits)
        moves = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in moves and len(moves) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert hasattr(cell.metric_reader(m["name"]), "read")
