"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``ssg_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``ssg_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is not. A
source is named by ``<name>``, or by its path (the measurement scripts
build other versions of a source and their own probes the same way). A
failed build raises, and nothing falls back to another implementation.
``launch_pairwise`` checks and converts the operands of the all-pairs
kernels (L1 and distance), allocates their output and launches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels need it")
    return path


def _source(name: str | Path) -> Path:
    return name if isinstance(name, Path) else CSRC / f"{name}.cu"


def _lib_path(name: str | Path) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(names: list[str | Path]) -> dict[str | Path, str]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns each name's ptxas report
    (empty for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{_source(name).name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return reports


def load(name: str | Path) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the source at a
    path), built first if needed."""
    path = _lib_path(name)
    lib = _loaded.get(path)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[path] = lib
    return lib


def same_operand(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``y`` is ``x`` itself: the same memory on the same device,
    with the same shape and strides (an all-pairs output is then symmetric)."""
    return x is y or (x.device == y.device and x.data_ptr() == y.data_ptr()
                      and x.shape == y.shape and x.stride() == y.stride())


def launch_pairwise(fn, what: str, x: torch.Tensor, y: torch.Tensor, *flags: int) -> torch.Tensor:
    """Launch an all-pairs kernel on x (M, D) and y (N, D), 2-D CUDA tensors
    on one device, into a new (M, N) fp32 output:
    ``fn(x, y, out, M, N, D, ldx, ldy, ldo, symmetric, *flags, stream)`` on
    the current stream, where ``symmetric`` is 1 when ``y`` is ``x``
    (``same_operand``). Operands of another type or layout are cast to fp32
    and made contiguous once, as the JAX package casts them; ``x`` is
    converted once and passed as ``y`` too when they are the same operand,
    so the symmetric case survives the conversion. Raises on a bad operand
    or a failed launch."""
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda" or t.dim() != 2:
            raise ValueError(f"{what}: {name} must be a 2-D CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device != y.device or x.shape[1] != y.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} on {x.device} and "
                         f"y {tuple(y.shape)} on {y.device} do not match")
    symmetric = same_operand(x, y)
    x = x.float().contiguous()
    y = x if symmetric else y.float().contiguous()
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d, x.stride(0),
                 y.stride(0), out.stride(0), int(symmetric), *flags, stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")
    return out
