"""All-pairs L1 (Manhattan) distance — the Jaccard workhorse of re-ranking.

Counterpart of ``ssg_tpu/ops/l1.py``. With row sums S of the sparse
encoding V, ``sum_k min(V_ik, V_jk) = (S_i + S_j - ||V_i - V_j||_1) / 2``
(see ops/rerank.py). On the card the distance is the hand-written CUDA
kernel ``csrc/l1.cu``; ``l1_distance_ref`` is its plain PyTorch version,
which the CPU runs and which the kernel is held against on the card. When
``y`` is omitted or is ``x`` itself (every call of the re-ranking), the
kernel computes each pair once and mirrors it, so the output is exactly
symmetric.
"""

from __future__ import annotations

import ctypes

import torch

from ssg_tpu_torch.ops import _build

# Kernel launches made by l1_distance (read by chip_smoke.py to show that
# the main path went through the kernel).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("l1").ssg_l1_distance
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def l1_distance_ref(x: torch.Tensor, y: torch.Tensor | None = None,
                    row_chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch all-pairs L1, fp32, row-chunked (mirrors ``_l1_xla``).
    Fewer rows a chunk where ``row_chunk`` rows would broadcast past 2^30
    elements (the streaming tiles, whose K is N)."""
    y = x if y is None else y
    x = x.float()
    y = y.float()
    row_chunk = max(1, min(row_chunk, 2**30 // max(y.shape[0] * x.shape[1], 1)))
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], row_chunk):
        out[s:s + row_chunk] = (x[s:s + row_chunk, None, :] - y[None]).abs().sum(-1)
    return out


def _l1_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    global launches
    out = _build.launch_pairwise(_kernel(), "l1_distance", x, y)
    launches += 1
    return out


# impl names: the port's, and the JAX package's as aliases.
_PLAIN = ("torch", "xla")
_KERNEL = ("auto", "pallas")


def l1_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
    """All-pairs L1 distance (M, D) x (N, D) -> (M, N), fp32.

    impl: ``"auto"`` (or JAX's ``"pallas"``) launches the CUDA kernel for
    CUDA tensors and takes the plain version for CPU
    tensors; ``"torch"`` (or JAX's ``"xla"``) takes the plain version on any
    device (the reference the kernel is compared with). Operands of any
    floating type or layout are converted to contiguous fp32 first.
    """
    y = x if y is None else y
    if impl not in _PLAIN + _KERNEL:
        raise ValueError(f"l1_distance: unknown impl {impl!r}")
    if impl in _PLAIN or x.device.type == "cpu":
        return l1_distance_ref(x, y)
    return _l1_cuda(x, y)
