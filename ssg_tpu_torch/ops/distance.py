"""All-pairs (squared) Euclidean distance, fp32.

Counterpart of ``ssg_tpu/ops/distance.py``: ``|x|^2 + |y|^2 - 2 x y^T``
clamped at 0, optional sqrt. Distances drive clustering decisions and are
never accumulated in a narrower type.

* ``impl="auto"`` is the JAX package's default ``_pairwise_xla``: the product
  is ``torch.matmul`` in true fp32 (TF32 off, ``_device.py``), matching its
  ``Precision.HIGHEST`` GEMM.
* ``impl="kernel"`` is its opt-in Pallas kernel (``impl="pallas"``): on the
  card the hand-written CUDA kernel ``csrc/distance.cu``, which fuses the
  norms into the product's K loop; on the CPU the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ssg_tpu_torch.ops import _build

# Kernel launches made by pairwise_distance(impl="kernel") (read by
# chip_smoke.py to show that a path went through the kernel).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("distance").ssg_pairwise_distance
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pairwise_distance_ref(x: torch.Tensor, y: torch.Tensor | None = None,
                          squared: bool = True) -> torch.Tensor:
    """Plain PyTorch version (``_pairwise_xla``): (N, D) x (M, D) -> (N, M) fp32."""
    x = x.float()
    y = x if y is None else y.float()
    x2 = (x * x).sum(1, keepdim=True)
    y2 = (y * y).sum(1, keepdim=True).T
    d = (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)
    return d if squared else d.sqrt()


def _distance_cuda(x: torch.Tensor, y: torch.Tensor, squared: bool) -> torch.Tensor:
    global launches
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"pairwise_distance: {name} must be a 2-D fp32 CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise_distance: {name} must be contiguous")
    if x.device != y.device or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_distance: x {tuple(x.shape)} on {x.device} and "
                         f"y {tuple(y.shape)} on {y.device} do not match")
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d,
                 x.stride(0), y.stride(0), out.stride(0), int(squared), stream)
    if err != 0:
        raise RuntimeError(f"pairwise_distance: kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def pairwise_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                      squared: bool = True, impl: str = "auto") -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) fp32; ``y`` defaults to ``x``.

    impl: ``"auto"`` (the cuBLAS formula, JAX's default) or ``"kernel"``
    (the CUDA kernel for CUDA tensors, the plain version for CPU tensors).
    """
    if impl not in ("auto", "kernel"):
        raise ValueError(f"pairwise_distance: unknown impl {impl!r}")
    if impl == "auto" or x.device.type == "cpu":
        return pairwise_distance_ref(x, y, squared)
    return _distance_cuda(x, x if y is None else y, squared)
