"""All-pairs L1 (Manhattan) distance — the Jaccard workhorse of re-ranking.

Counterpart of ``ssg_tpu/ops/l1.py``. With row sums S of the sparse
encoding V, ``sum_k min(V_ik, V_jk) = (S_i + S_j - ||V_i - V_j||_1) / 2``
(see ops/rerank.py). On the card the distance is the hand-written CUDA
kernel ``csrc/l1.cu``; ``l1_distance_ref`` is its plain PyTorch version,
which the CPU runs and which the kernel is held against on the card.
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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def l1_distance_ref(x: torch.Tensor, y: torch.Tensor | None = None,
                    row_chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch all-pairs L1, fp32, row-chunked (mirrors ``_l1_xla``)."""
    y = x if y is None else y
    x = x.float()
    y = y.float()
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], row_chunk):
        out[s:s + row_chunk] = (x[s:s + row_chunk, None, :] - y[None]).abs().sum(-1)
    return out


def _l1_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    global launches
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"l1_distance: {name} must be a 2-D fp32 CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"l1_distance: {name} must be contiguous")
    if x.device != y.device or x.shape[1] != y.shape[1]:
        raise ValueError(f"l1_distance: x {tuple(x.shape)} on {x.device} and "
                         f"y {tuple(y.shape)} on {y.device} do not match")
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d,
                 x.stride(0), y.stride(0), out.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"l1_distance: kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def l1_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
    """All-pairs L1 distance (M, D) x (N, D) -> (M, N), fp32.

    impl: ``"auto"`` launches the CUDA kernel for CUDA tensors and takes the
    plain version for CPU tensors; ``"torch"`` takes the plain version on
    any device (the reference the kernel is compared with).
    """
    y = x if y is None else y
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        return l1_distance_ref(x, y)
    if impl != "auto":
        raise ValueError(f"l1_distance: unknown impl {impl!r}")
    return _l1_cuda(x, y)
