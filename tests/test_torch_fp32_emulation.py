"""The fp32 bottleneck kernel's arithmetic, emulated on the CPU.

``csrc/bottleneck.cu``'s ``conv_f32_kernel`` runs every fp32 block conv as
an implicit GEMM on the TF32 tensor cores at fp32 accuracy (3xTF32): each
operand is split into a TF32 ``hi`` (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero, to 10 mantissa bits) and a TF32 ``lo`` rounded from the
exact remainder; each 8-deep step adds ``lo.hi``, ``hi.lo`` and ``hi.hi``
into a per-slab partial sum (32 deep), which an fp32 add folds into the
accumulator; the epilogue adds the bias, then the residual, then the ReLU.
The card cannot be asked here, so this file repeats that arithmetic with
torch on the CPU (the rounding by bit masking) and holds it to the block in
fp64 and to the JAX kernel (Pallas in interpret mode), within ``FP32_REL``
of the largest output: the tolerance the card tests hold the kernel to.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ssg_tpu.ops import bottleneck as jax_bn

FP32_REL = 1e-4  # as in tests/test_torch_cuda.py and chip_smoke.py
SLAB = 32  # K of a ring slab: one partial sum
STEP = 8  # K of an mma.sync m16n8k8


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 values: add half of the 13 dropped bits'
    range to the magnitude bits (the sign bit is apart), then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def im2col(x: torch.Tensor, r: int, s: int) -> torch.Tensor:
    """NHWC ``x`` -> (B Ho Wo, R R Cin) rows of the kernel's A, k = (dr R + dc)
    Cin + ci, zero outside the image."""
    b, h, w, c = x.shape
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    xp = F.pad(x, (0, 0, r // 2, r // 2, r // 2, r // 2))
    taps = [xp[:, dr:dr + (ho - 1) * s + 1:s, dc:dc + (wo - 1) * s + 1:s]
            for dr in range(r) for dc in range(r)]
    return torch.cat(taps, -1).reshape(b * ho * wo, r * r * c)


def conv_3xtf32(x, w, bias, r: int, s: int, res=None, relu: bool = True, terms: int = 3):
    """One launch of the kernel: ``w`` is (R, R, Cin, Cout) or (Cin, Cout).
    ``terms=1`` keeps only hi.hi (plain TF32), to show what the lo terms carry."""
    b, h, wd, _ = x.shape
    ho, wo = (h - 1) // s + 1, (wd - 1) // s + 1
    a = im2col(x, r, s)
    wk = w.reshape(-1, w.shape[-1])
    acc = torch.zeros((a.shape[0], wk.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], SLAB):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + SLAB, a.shape[1]), STEP):
            ak, bk = a[:, k:k + STEP], wk[k:k + STEP]
            ahi, bhi = tf32(ak), tf32(bk)
            alo, blo = tf32(ak - ahi), tf32(bk - bhi)
            if terms == 3:
                part = part + alo @ bhi
                part = part + ahi @ blo
            part = part + ahi @ bhi
        acc = acc + part
    out = (acc + bias).reshape(b, ho, wo, -1)
    if res is not None:
        out = out + res
    return torch.relu(out) if relu else out


def block_3xtf32(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride: int = 1, terms: int = 3):
    """``ssg_bottleneck_f32``'s launches: y1, y2 (and a downsample residual)
    rounded to fp32 between them, as they pass through device memory."""
    y1 = conv_3xtf32(x, w1, b1, 1, 1, terms=terms)
    y2 = conv_3xtf32(y1, w2, b2, 3, stride, terms=terms)
    res = x if wd is None else conv_3xtf32(x, wd, bd, 1, stride, relu=False, terms=terms)
    return conv_3xtf32(y2, w3, b3, 1, 1, res=res, terms=terms)


def block_f64(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride: int = 1):
    x, w1, b1, w2, b2, w3, b3 = (t.double() for t in (x, w1, b1, w2, b2, w3, b3))
    y = torch.relu(x @ w1 + b1)
    y = F.conv2d(y.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1), stride=stride, padding=1)
    y = torch.relu(y.permute(0, 2, 3, 1) + b2) @ w3 + b3
    res = x if wd is None else x[:, ::stride, ::stride] @ wd.double() + bd.double()
    return torch.relu(y + res)


def _inputs(rng, b, h, w, c, cm, cout, ds):
    x = torch.from_numpy(np.abs(rng.normal(size=(b, h, w, c))).astype(np.float32))
    shapes = [(c, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    shapes += [(c, cout), (cout,)] if ds else []
    ws = [torch.from_numpy((rng.normal(size=sh) * (0.1 if len(sh) == 1 else np.prod(sh[:-1]) ** -0.5))
                           .astype(np.float32)) for sh in shapes]
    return x, ws


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # a TF32 value: 10 mantissa bits
    vals = torch.tensor([one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                         1.0 + 3 * 2.0 ** -12, 0.0, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, one, 0.0, 3.0e-39], dtype=torch.float32)
    got = tf32(vals)
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo carries 21 significant bits: the split loses ~2^-22 of the value.
    v = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = tf32(v)
    assert float(((hi + tf32(v - hi)) - v).abs().div(v.abs()).max()) < 2.0 ** -20


# Cin 40 and Cm 24 put 32-deep slab edges inside taps of the 3x3 (K = 40,
# 216, 24); a stride-2 downsample block with its strided 1x1 residual; a
# 64-channel block whose K = 576 is 18 slabs.
@pytest.mark.parametrize("b,h,w,c,cm,cout,stride", [(2, 9, 13, 40, 24, 40, 1),
                                                    (2, 9, 7, 24, 8, 32, 2),
                                                    (1, 8, 6, 64, 64, 256, 1)])
def test_fp32_kernel_arithmetic_matches_fp64(rng, b, h, w, c, cm, cout, stride):
    ds = stride != 1 or cout != c
    x, ws = _inputs(rng, b, h, w, c, cm, cout, ds)
    exact = block_f64(x, *ws, stride=stride)
    scale = float(exact.abs().max())
    out = block_3xtf32(x, *ws, stride=stride)
    assert out.dtype == torch.float32 and out.shape == exact.shape
    err = float((out.double() - exact).abs().max())
    assert err <= FP32_REL * scale
    # Plain TF32 (hi.hi alone) is what the lo terms correct: its error is
    # at least ten times the emulated kernel's.
    tf32_err = float((block_3xtf32(x, *ws, stride=stride, terms=1).double() - exact).abs().max())
    assert tf32_err >= 10 * err


def test_fp32_kernel_arithmetic_matches_jax_kernel(rng):
    x, ws = _inputs(rng, 2, 9, 13, 40, 24, 40, False)
    out = block_3xtf32(x, *ws).numpy()
    jx = np.asarray(jax_bn.fused_bottleneck(jnp.asarray(x.numpy()),
                                            *(jnp.asarray(t.numpy()) for t in ws),
                                            interpret=True))
    assert out.shape == jx.shape
    assert float(np.abs(out - jx).max()) <= FP32_REL * float(np.abs(jx).max())
