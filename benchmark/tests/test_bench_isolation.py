"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's own name begins with the JAX package's), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.tests.tiny import BENCH, ROOT

LOAD_ALL = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark import run, calibrate, faults, harness
from benchmark.reference import cluster, resnet
here = Path({str(BENCH)!r})
for sub in ("kinds", "metrics"):
    for p in sorted((here / sub).glob("*.py")):
        harness.load_module(p, "probe_" + sub + "_" + p.stem.replace(".", "_"))
import ssg_tpu_torch.api, ssg_tpu_torch.train.trainer
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_loaded():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout.strip().splitlines()[-1]
    tops = set(out.split(","))
    assert "ssg_tpu_torch" in tops and "benchmark" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ssg_tpu"}


def test_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "ssg_tpu_torch_probe", sys)
    assert "ssg_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ssg_tpu.probe", sys)
    assert harness.forbidden_modules() == ["ssg_tpu.probe"]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in {"ssg_tpu_torch", "ssg_tpu", "jax", "flax"}, (
                    path.name, name)
                assert not name.startswith(("benchmark.program", "benchmark.kinds")), (
                    path.name, name)
