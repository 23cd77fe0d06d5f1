"""The port stands alone: ``ssg_tpu_torch`` and its scripts import
neither JAX, Flax nor the JAX package, not even its numpy-only modules."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "ssg_tpu")
SOURCES = sorted((ROOT / "ssg_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_import_loads_no_jax():
    code = ("import sys, ssg_tpu_torch, ssg_tpu_torch.api, ssg_tpu_torch.models, "
            "ssg_tpu_torch.ops, ssg_tpu_torch.train.ssg_loop, ssg_tpu_torch.utils, "
            "ssg_tpu_torch.loss, ssg_tpu_torch.evaluation_metrics, "
            "ssg_tpu_torch.train.pretrain, ssg_tpu_torch.cli.pretraining, "
            "ssg_tpu_torch.cli.selftraining, ssg_tpu_torch.cli.semitraining, "
            "ssg_tpu_torch.parallel, ssg_tpu_torch.parallel.streaming, "
            "ssg_tpu_torch.ops.bits, ssg_tpu_torch.ops.minsum, ssg_tpu_torch.cli.prepare, "
            "ssg_tpu_torch.data.prepare, ssg_tpu_torch.data.native_loader, "
            "ssg_tpu_torch.models.inception, ssg_tpu_torch.metric_learning, "
            "ssg_tpu_torch.dist_metric, ssg_tpu_torch.feature_extraction, "
            "ssg_tpu_torch.utils.profiling, ssg_tpu_torch.utils.traceview, ssg_tpu_torch.entry, "
            "ssg_tpu_torch.data.synthetic_device, bench_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ssg_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_only_the_factory_imports_the_resnets():
    """The shared layers and heads live in ``models.layers`` and
    ``models.heads``: no module of the port but ``models/__init__.py``
    reaches into ``models.resnet`` for them."""
    package = ROOT / "ssg_tpu_torch"
    resnet = "ssg_tpu_torch.models.resnet"
    offenders = []
    for path in sorted(package.rglob("*.py")):
        if path == package / "models" / "__init__.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            if resnet in names:
                offenders.append(str(path.relative_to(ROOT)))
    assert not offenders, offenders
