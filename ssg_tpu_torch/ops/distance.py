"""All-pairs (squared) Euclidean distance, fp32.

Counterpart of ``ssg_tpu/ops/distance.py``: ``|x|^2 + |y|^2 - 2 x y^T``
clamped at 0, optional sqrt. Distances drive clustering decisions and are
never accumulated in a narrower type.

* ``impl="auto"`` is the JAX package's default ``_pairwise_xla``: the product
  is ``torch.matmul`` in true fp32 (TF32 off, ``_device.py``), matching its
  ``Precision.HIGHEST`` GEMM.
* ``impl="kernel"`` is its opt-in Pallas kernel (``impl="pallas"``, which
  the port takes as an alias, as it takes ``"xla"`` for ``"auto"``): on the
  card the hand-written CUDA kernel ``csrc/distance.cu`` (3xTF32 products
  on the tensor cores, fp32-accurate, with the norms fused into the K
  loop); on the CPU the plain version. When ``y`` is omitted or is ``x``
  itself, the kernel computes each pair once and mirrors it, so the output
  is exactly symmetric.
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
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    out = _build.launch_pairwise(_kernel(), "pairwise_distance", x, y, int(squared))
    launches += 1
    return out


def pairwise_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                      squared: bool = True, impl: str = "auto") -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) fp32; ``y`` defaults to ``x``.

    impl: ``"auto"`` (or JAX's ``"xla"``: the cuBLAS formula, JAX's default)
    or ``"kernel"`` (or JAX's ``"pallas"``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors).
    """
    if impl not in ("auto", "xla", "kernel", "pallas"):
        raise ValueError(f"pairwise_distance: unknown impl {impl!r}")
    if impl in ("auto", "xla") or x.device.type == "cpu":
        return pairwise_distance_ref(x, y, squared)
    return _distance_cuda(x, x if y is None else y, squared)
