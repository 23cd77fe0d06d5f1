"""Fused eval-mode ResNet bottleneck, BatchNorm folded into the convolutions.

Counterpart of ``ssg_tpu/ops/bottleneck.py``. An identity bottleneck
(stride 1, ``C == Cout``) with BN folded by ``fold_bn`` computes, on NHWC
activations of type ``x.dtype`` with fp32 accumulation:

    y1  = relu(x @ w1 + b1)            -> x.dtype
    y2  = relu(conv3x3(y1, w2) + b2)   -> x.dtype
    out = relu(y2 @ w3 + b3 + x)       -> x.dtype

On the card it is the hand-written CUDA source ``csrc/bottleneck.cu``: for
bf16 one fused kernel that keeps y1 and y2 in shared memory, for fp32 a run
of implicit-GEMM launches at fp32 accuracy on the TF32 tensor cores
(3xTF32). ``bottleneck_ref`` is its plain PyTorch version: the
CPU runs it, and the kernels are held against it on the card.
Public layouts are the JAX package's: NHWC ``x``, w1 ``(C, Cm)``, w2
``(3, 3, Cm, Cm)`` (HWIO), w3 ``(Cm, C)``, fp32 biases.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ssg_tpu_torch.ops import _build

# Kernel launches made by fused_bottleneck (read by chip_smoke.py to show
# that the fused-eval path went through the kernel).
launches = 0

# C signatures of the kernel entry points of csrc/bottleneck.cu.
_SIGNATURES = {
    "ssg_bottleneck": [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 7 + [ctypes.c_void_p],
    "ssg_bottleneck_f32": [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 7 + [ctypes.c_void_p],
    "ssg_bottleneck_plan": [ctypes.c_int64] * 6 + [ctypes.c_void_p],
}
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give the entry points ``lib`` has of ``_SIGNATURES`` their C
    signatures: a library built from ``csrc/bottleneck.cu``, or from another
    version of that source with the same interface (``_build.load(path)``)."""
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib_fn(name: str):
    global _lib
    if _lib is None:
        _lib = bind(_build.load("bottleneck"))
    return getattr(_lib, name)


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the preceding conv, in fp32.

    ``conv(x, k) -> bn`` equals ``conv(x, k * s) + b`` with
    ``s = scale / sqrt(var + eps)`` and ``b = bias - mean * s``. ``kernel``
    is ``(..., Cout)``; the caller casts the folded kernel to the activation
    type, so it is rounded once.
    """
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return kernel.float() * s, bias.float() - mean.float() * s


@contextlib.contextmanager
def _true_fp32():
    """fp32 products and convolutions without TF32, on any device."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _conv3x3(y, w2, stride: int):
    """NHWC fp32 ``y`` (*) HWIO ``w2``, padding 1."""
    out = F.conv2d(y.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1), stride=stride, padding=1)
    return out.permute(0, 2, 3, 1)


def block_ref(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride: int = 1):
    """Plain version of one folded block: identity (``wd is None``) or with
    a strided 1x1 downsample residual. Computed in fp32 on the values of
    ``x.dtype`` (a product of two bf16 values is exact in fp32), rounded to
    ``x.dtype`` where the kernel rounds: after y1, after y2, at the output."""
    dt = x.dtype

    def q(w):  # the kernel's operand: the weight in the activation type
        return w.to(dt).float()

    with _true_fp32():
        xf = x.float()
        y = torch.relu(xf @ q(w1) + b1.float()).to(dt)
        y = torch.relu(_conv3x3(y.float(), q(w2), stride) + b2.float()).to(dt)
        y = y.float() @ q(w3) + b3.float()
        if wd is None:
            res = xf
        else:
            res = xf[:, ::stride, ::stride] @ q(wd) + bd.float()
        return torch.relu(y + res).to(dt)


def bottleneck_ref(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch identity block (mirrors ``ssg_tpu.ops.bottleneck.bottleneck_ref``)."""
    return block_ref(x, w1, b1, w2, b2, w3, b3)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"fused_bottleneck: {name} must be {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_bottleneck: {name} must be contiguous and 16-byte aligned")


def launch_block(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride: int = 1) -> torch.Tensor:
    """One block by ``csrc/bottleneck.cu`` on CUDA tensors; counts nothing.

    ``x`` is NHWC-contiguous (a channels-last NCHW tensor permuted to NHWC
    is), bf16 (one launch of the fused kernel) or fp32 (``ssg_bottleneck_f32``:
    three launches of the 3xTF32 kernel, four with a downsample, through
    workspaces in device memory). Weights are cast to ``x.dtype`` (a no-op
    for folded weights) and must then be contiguous; biases are fp32.
    """
    if (x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32)
            or x.dim() != 4):
        raise ValueError(f"fused_bottleneck: x must be a 4-D bf16 or fp32 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if stride not in (1, 2) or (wd is None and stride != 1):
        raise ValueError(f"fused_bottleneck: stride {stride} needs a downsample block")
    b, h, w, c = x.shape
    cm, cout = w1.shape[-1], w3.shape[-1]
    if c % 8 or cm % 8 or cout % 8 or (wd is None and cout != c):
        raise ValueError(f"fused_bottleneck: channels C={c}, Cm={cm}, Cout={cout} must be "
                         "multiples of 8 (and Cout == C for an identity block)")
    dev, dt = x.device, x.dtype
    _check("x", x, dt, (b, h, w, c), dev)
    w1, w2, w3 = w1.to(dt), w2.to(dt), w3.to(dt)
    b1, b2, b3 = b1.float(), b2.float(), b3.float()
    for name, t, shape in (("w1", w1, (c, cm)), ("w2", w2, (3, 3, cm, cm)),
                           ("w3", w3, (cm, cout))):
        _check(name, t, dt, shape, dev)
    for name, t, n in (("b1", b1, cm), ("b2", b2, cm), ("b3", b3, cout)):
        _check(name, t, torch.float32, (n,), dev)
    ptrs = [None, None]
    if wd is not None:
        wd, bd = wd.to(dt), bd.float()
        _check("wd", wd, dt, (c, cout), dev)
        _check("bd", bd, torch.float32, (cout,), dev)
        ptrs = [wd.data_ptr(), bd.data_ptr()]
    out = torch.empty((b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout), dtype=dt, device=dev)
    args = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, out.data_ptr()]
    if dt == torch.float32:
        # Workspaces for y1, y2 and a downsample residual; freed when this
        # returns, which the caching allocator orders after the stream's use.
        y1 = torch.empty((b, h, w, cm), dtype=dt, device=dev)
        y2 = torch.empty(out.shape[:3] + (cm,), dtype=dt, device=dev)
        res = torch.empty_like(out) if wd is not None else None
        args += [y1.data_ptr(), y2.data_ptr(), None if res is None else res.data_ptr()]
    fn = _lib_fn("ssg_bottleneck" if dt == torch.bfloat16 else "ssg_bottleneck_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, b, h, w, c, cm, cout, stride, stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck: kernel launch failed with CUDA error {err}")
    return out


def plan(b: int, h: int, w: int, cm: int, stride: int = 1, downsample: bool = False) -> dict:
    """The kernel's output tile, grid and shared memory for an input shape."""
    out = (ctypes.c_int64 * 5)()
    err = _lib_fn("ssg_bottleneck_plan")(b, h, w, cm, stride, int(downsample), out)
    if err != 0:
        raise ValueError(f"fused_bottleneck: no tile fits Cm={cm} (CUDA error {err})")
    return dict(zip(("tile_rows", "tile_cols", "blocks", "smem_bytes", "ring_slots"), out))


def bf16_ulp_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``|out - ref|`` in units of the bf16 ulp of ``max(|ref|, rms(ref))``.

    The yardstick for the kernel against its plain version: both round y1,
    y2 and the output to bf16, and fp32 sums taken in another order can flip
    one of those roundings; a flipped y1 or y2 moves an output by a fraction
    of an ulp of the output's typical size, whatever its own size. The floor
    keeps outputs near 0 (where ReLU clamps) from being measured in ulps of
    nearly nothing.
    """
    o, r = out.float(), ref.float()
    floor = r.square().mean().sqrt()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(r.abs(), floor).clamp_min(1e-30))) - 7)
    return float(((o - r).abs() / ulp).max())


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """Identity bottleneck with BN pre-folded into (w, b) pairs.

    x: (B, H, W, C) NHWC; w1 (C, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, C); b*: fp32.
    Returns (B, H, W, C) in ``x.dtype``. CUDA tensors launch the kernel
    (bf16 or fp32, NHWC-contiguous, channels multiples of 8, else it
    raises); CPU tensors take the plain version.
    """
    global launches
    if x.device.type == "cpu":
        return bottleneck_ref(x, w1, b1, w2, b2, w3, b3)
    out = launch_block(x, w1, b1, w2, b2, w3, b3)
    launches += 1
    return out
