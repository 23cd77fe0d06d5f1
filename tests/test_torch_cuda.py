"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed, without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.ops import bottleneck as bn_mod
from ssg_tpu_torch.ops import bottleneck_stage as stage_mod
from ssg_tpu_torch.ops import distance as dist_mod
from ssg_tpu_torch.ops import l1 as l1_mod
from ssg_tpu_torch.ops.bottleneck import bf16_ulp_error, bottleneck_ref, fused_bottleneck
from ssg_tpu_torch.ops.bottleneck_stage import fused_bottleneck_stage, stage_ref
from ssg_tpu_torch.ops.distance import pairwise_distance, pairwise_distance_ref
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return resolve_device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


# General calls (y given), ragged against the kernel's 128-, 64- and 32-row
# units (the last shape is large enough for 128), its 64-wide column units
# and its 32-wide K slab.
@pytest.mark.parametrize("m,n,d", [(70, 33, 150), (5, 7, 3), (129, 64, 65), (1, 1, 1),
                                   (1000, 333, 777), (2100, 2000, 70)])
def test_l1_kernel_matches_ref(gen, cuda, m, n, d):
    x = torch.from_numpy(gen.normal(size=(m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = l1_mod.launches
    out = l1_distance(x, y)
    torch.cuda.synchronize()
    assert l1_mod.launches == before + 1
    ref = l1_distance_ref(x, y)
    # fp32 sums in another order: 1e-5 of the row-sum scale.
    scale = float(x.abs().sum(1).max() + y.abs().sum(1).max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale


# Symmetric calls (y omitted): ragged against the 128- and 64-row tiles, the
# 64-wide column units and the 32-wide K slab. The kernel computes the upper
# triangle and mirrors it; every output sums its k in order, as the general
# path does, so the two give the same bits.
@pytest.mark.parametrize("n,d", [(1, 1), (5, 3), (65, 33), (130, 150), (1000, 777),
                                 (1283, 130)])
def test_l1_kernel_symmetric(gen, cuda, n, d):
    x = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = l1_mod.launches
    out = l1_distance(x)
    torch.cuda.synchronize()
    assert l1_mod.launches == before + 1
    assert torch.equal(out, out.T)
    ref = l1_distance_ref(x)
    assert float((out - ref).abs().max()) <= 1e-5 * 2 * float(x.abs().sum(1).max())
    assert torch.equal(out, l1_distance(x, x.clone()))  # the general path


def test_l1_kernel_v_like(gen, cuda):
    # The re-ranking's operand: sparse, non-negative, rows summing to 1.
    n = 700
    v = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), 40)
    np.add.at(v, (rows, gen.integers(0, n, rows.size)), gen.random(rows.size).astype(np.float32))
    v /= v.sum(1, keepdims=True)
    x = torch.from_numpy(v).to(cuda)
    out = l1_distance(x)
    torch.cuda.synchronize()
    assert torch.equal(out, out.T)
    assert float((out - l1_distance_ref(x)).abs().max()) <= 1e-5 * 2


def test_l1_kernel_rejects_bad_input(cuda):
    x = torch.ones((8, 4), device=cuda)
    with pytest.raises(ValueError):
        l1_distance(x, torch.ones((8, 5), device=cuda))
    with pytest.raises(ValueError):
        l1_distance(x, impl="nope")


# Operands JAX accepts: another floating type, a strided view. The wrapper
# converts them to contiguous fp32 once, as JAX casts; a view against itself
# stays the symmetric case (exactly symmetric output), and the result equals
# the kernel on the converted operands.
@pytest.mark.parametrize("kernel", ["l1", "distance"])
def test_pairwise_kernels_convert_operands_like_jax(gen, cuda, kernel):
    def call(a, b=None):
        if kernel == "l1":
            return l1_distance(a, b, impl="pallas")
        return pairwise_distance(a, b, impl="pallas")

    mod = l1_mod if kernel == "l1" else dist_mod
    base = torch.from_numpy(gen.normal(size=(300, 130)).astype(np.float32)).to(cuda)
    strided = base[::2, 1:]  # (150, 129), rows not contiguous
    for x in (strided, strided.to(torch.bfloat16), strided.double(), base.T):
        before = mod.launches
        out = call(x)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        assert torch.equal(out, out.T)  # y is x: the symmetric launch
        assert torch.equal(out, call(x.float().contiguous()))
    y = base[1::2, :129].to(torch.bfloat16)
    torch.testing.assert_close(call(strided.to(torch.bfloat16), y),
                               call(strided.to(torch.bfloat16).float(), y.float()),
                               rtol=0, atol=0)


def test_cluster_groups_card_matches_cpu(gen, cuda):
    centers = gen.normal(size=(20, 64)) * 2.0
    pts = centers[np.repeat(np.arange(20), 10)] + gen.normal(size=(200, 64))
    f = np.stack([pts, pts[::-1]]).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    kw = dict(k1=20, k2=6, lambda_value=0.1, rho=0.02, min_samples=4)
    lc, nc, ec = api.cluster_groups(f, device="cpu", **kw)
    before = l1_mod.launches
    lg, ng, eg = api.cluster_groups(f, device=cuda, **kw)
    assert l1_mod.launches == before + 2
    np.testing.assert_array_equal(lg, lc)
    assert ng == nc
    np.testing.assert_allclose(eg, ec, rtol=1e-5)


# bf16 kernel against the plain version: y1, y2 and the output are rounded
# to bf16 on both sides, and fp32 sums in another order may flip one of those
# roundings, so the bound is in output ulps (bn_mod.bf16_ulp_error), per
# block of a stage, since each block passes its input's differences on.
BF16_ULPS = 4


def _weights(gen, cin, cm, cout, ds, device):
    shapes = [(cin, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    fans = [cin, 1, 9 * cm, 1, cm, 1]
    if ds:
        shapes += [(cin, cout), (cout,)]
        fans += [cin, 1]
    out = []
    for shape, fan in zip(shapes, fans):
        a = torch.from_numpy(gen.normal(size=shape).astype(np.float32) * (0.1 if fan == 1 else fan ** -0.5))
        out.append(a.to(device, torch.bfloat16 if len(shape) > 1 else torch.float32))
    return tuple(out)


def _act(gen, shape, device):
    return torch.from_numpy(np.abs(gen.normal(size=shape)).astype(np.float32)).to(device, torch.bfloat16)


# Ragged spatial and channel sizes ((2, 1) map, Cm 8, odd W, C 40), then the
# four ResNet-50 identity-block widths.
@pytest.mark.parametrize("b,h,w,c,cm", [(2, 2, 1, 64, 16), (3, 5, 7, 32, 8), (2, 9, 13, 40, 8),
                                        (4, 8, 6, 64, 16), (2, 64, 32, 256, 64),
                                        (2, 32, 16, 512, 128), (2, 16, 8, 1024, 256),
                                        (3, 8, 4, 2048, 512)])
def test_bottleneck_kernel_matches_ref(gen, cuda, b, h, w, c, cm):
    x = _act(gen, (b, h, w, c), cuda)
    ws = _weights(gen, c, cm, c, False, cuda)
    before = bn_mod.launches
    out = fused_bottleneck(x, *ws)
    torch.cuda.synchronize()
    assert bn_mod.launches == before + 1
    ref = bottleneck_ref(x, *ws)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert bf16_ulp_error(out, ref) <= BF16_ULPS


# Grids of 1-3 blocks, at the layer3 and layer4 widths, and C=40 / Cm=8,
# whose K = C, 9 Cm and Cm straddle a 16-deep step of the products.
@pytest.mark.parametrize("b,h,w,c,cm", [(1, 16, 8, 1024, 256), (3, 16, 8, 1024, 256),
                                        (1, 9, 7, 1024, 256), (3, 9, 7, 1024, 256),
                                        (1, 8, 4, 2048, 512), (3, 8, 4, 2048, 512),
                                        (3, 9, 13, 40, 8)])
def test_bottleneck_kernel_small_batch_matches_ref(gen, cuda, b, h, w, c, cm):
    x = _act(gen, (b, h, w, c), cuda)
    ws = _weights(gen, c, cm, c, False, cuda)
    out = fused_bottleneck(x, *ws)
    torch.cuda.synchronize()
    ref = bottleneck_ref(x, *ws)
    assert bool(torch.isfinite(out.float()).all())
    assert bf16_ulp_error(out, ref) <= BF16_ULPS


# fp32 blocks (the fp32 kernel, y1 and y2 through device memory) against the
# plain version in true fp32: sums in another order, within 1e-4 of the
# largest output. A 3-block stage also runs the downsample block.
FP32_REL = 1e-4


@pytest.mark.parametrize("b,h,w,c,cm", [(3, 5, 7, 32, 8), (2, 9, 13, 40, 8),
                                        (2, 16, 8, 1024, 256), (1, 8, 4, 2048, 512)])
def test_bottleneck_kernel_fp32_matches_ref(gen, cuda, b, h, w, c, cm):
    x = _act(gen, (b, h, w, c), cuda).float()
    ws = tuple(t.float() for t in _weights(gen, c, cm, c, False, cuda))
    before = bn_mod.launches
    out = fused_bottleneck(x, *ws)
    torch.cuda.synchronize()
    assert bn_mod.launches == before + 1
    ref = bottleneck_ref(x, *ws)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= FP32_REL * float(ref.abs().max())


@pytest.mark.parametrize("stride,h,w,c,cm", [(2, 9, 7, 24, 8), (1, 16, 8, 64, 16),
                                             (2, 16, 8, 256, 128)])
def test_stage_kernel_fp32_matches_ref(gen, cuda, stride, h, w, c, cm):
    x = _act(gen, (2, h, w, c), cuda).float()
    blocks = [tuple(t.float() for t in _weights(gen, cin, cm, 4 * cm, i == 0, cuda))
              for i, cin in enumerate((c, 4 * cm, 4 * cm))]
    before = stage_mod.launches
    out = fused_bottleneck_stage(x, blocks, stride)
    torch.cuda.synchronize()
    assert stage_mod.launches == before + 3
    ref = stage_ref(x, blocks, stride)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= FP32_REL * float(ref.abs().max())


@pytest.mark.parametrize("stride,h,w,c,cm", [(1, 16, 8, 16, 8), (2, 16, 8, 16, 8),
                                             (2, 9, 7, 24, 8), (1, 64, 32, 64, 64),
                                             (2, 64, 32, 256, 128), (2, 16, 8, 1024, 512)])
def test_stage_kernel_matches_ref(gen, cuda, stride, h, w, c, cm):
    x = _act(gen, (2, h, w, c), cuda)
    blocks = (_weights(gen, c, cm, 4 * cm, True, cuda),
              _weights(gen, 4 * cm, cm, 4 * cm, False, cuda),
              _weights(gen, 4 * cm, cm, 4 * cm, False, cuda))
    before = stage_mod.launches
    out = fused_bottleneck_stage(x, blocks, stride)
    torch.cuda.synchronize()
    assert stage_mod.launches == before + 3
    ref = stage_ref(x, blocks, stride)
    assert out.shape == ref.shape == (2, (h - 1) // stride + 1, (w - 1) // stride + 1, 4 * cm)
    assert bf16_ulp_error(out, ref) <= BF16_ULPS * len(blocks)


def test_bottleneck_kernel_rejects_bad_input(gen, cuda):
    x = _act(gen, (2, 4, 4, 64), cuda)
    ws = _weights(gen, 64, 16, 64, False, cuda)
    with pytest.raises(ValueError):
        fused_bottleneck(x.half(), *ws)  # fp16 activations
    with pytest.raises(ValueError):
        fused_bottleneck(x.permute(0, 2, 1, 3), *ws)  # not NHWC-contiguous
    with pytest.raises(ValueError):
        fused_bottleneck(x, ws[0][:, :12].contiguous(), ws[1][:12], *ws[2:])  # Cm not 8k
    with pytest.raises(ValueError):
        fused_bottleneck(x, ws[0].T, *ws[1:])  # w1 transposed
    with pytest.raises(ValueError):
        fused_bottleneck_stage(x, (ws, _weights(gen, 64, 16, 64, True, cuda)), 1)


@pytest.mark.parametrize("m,n,d,squared", [(70, 33, 150, True), (5, 7, 3, False),
                                           (129, 257, 65, True), (1, 1, 1, False),
                                           (1000, 333, 2048, True)])
def test_distance_kernel_matches_ref(gen, cuda, m, n, d, squared):
    x = torch.from_numpy(gen.normal(size=(m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = dist_mod.launches
    out = pairwise_distance(x, y, squared=squared, impl="kernel")
    torch.cuda.synchronize()
    assert dist_mod.launches == before + 1
    ref = pairwise_distance_ref(x, y, squared=squared)
    # fp32 sums in another order: 1e-5 of the |x|^2 + |y|^2 scale (its
    # square root for plain distances).
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    assert float((out - ref).abs().max()) <= 1e-5 * (scale if squared else scale ** 0.5)


# Symmetric calls (y omitted), ragged against the 128-square tile and the
# 32-wide K slab: the output is exactly symmetric and within the tolerance
# above. Plain distances off the diagonal likewise; on it, |x|^2 + |x|^2 -
# 2 x.x cancels to an fp32 residue that sqrt magnifies, so only near 0.
@pytest.mark.parametrize("n,d", [(1, 1), (5, 3), (65, 65), (130, 2048), (1000, 777),
                                 (1283, 130)])
@pytest.mark.parametrize("squared", [True, False])
def test_distance_kernel_symmetric(gen, cuda, n, d, squared):
    x = torch.from_numpy(gen.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = dist_mod.launches
    out = pairwise_distance(x, squared=squared, impl="kernel")
    torch.cuda.synchronize()
    assert dist_mod.launches == before + 1
    assert torch.equal(out, out.T)
    ref = pairwise_distance_ref(x, squared=squared)
    scale = 2 * float((x * x).sum(1).max())
    if squared:
        assert float((out - ref).abs().max()) <= 1e-5 * scale
    else:
        off = ~torch.eye(n, dtype=torch.bool, device=cuda)
        assert float((out - ref).masked_fill(~off, 0).abs().max()) <= 1e-5 * scale ** 0.5
        assert float(out.diagonal().abs().max()) <= 1e-2 * scale ** 0.5


def test_distance_kernel_rejects_bad_input(cuda):
    x = torch.ones((8, 4), device=cuda)
    with pytest.raises(ValueError):
        pairwise_distance(x, torch.ones((8, 5), device=cuda), impl="kernel")
    with pytest.raises(ValueError):
        pairwise_distance(x, impl="nope")


def test_fused_eval_model_matches_unfused(cuda):
    kw = dict(num_features=0, num_parts=3, dtype=torch.bfloat16)
    plain = models.create("resnet50", **kw).reset_parameters(torch.Generator().manual_seed(0))
    fused = models.create("resnet50", fused_eval=True, **kw)
    fused.load_state_dict(plain.state_dict())
    plain = plain.eval().to(cuda, memory_format=torch.channels_last)
    fused = fused.eval().to(cuda, memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 256, 128, 3)).astype(np.float32))
    before = bn_mod.launches
    with torch.no_grad():
        a = plain(x.to(cuda))["embeddings"]
        b = fused(x.to(cuda))["embeddings"]
    torch.cuda.synchronize()
    assert bn_mod.launches == before + 12  # the 12 identity blocks of ResNet-50
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    assert float(cos.min()) >= 0.99


def test_fused_eval_fp32_model_matches_unfused(cuda):
    # fp32 blocks run the fp32 kernel (the model in NCHW: each block copies
    # its input to NHWC once); each embedding within 1e-4 (relative, in norm)
    # of the unfused fp32 model's: fp32 rounding of the fold.
    kw = dict(num_features=0, num_parts=3, dtype=torch.float32)
    plain = models.create("resnet50", **kw).reset_parameters(torch.Generator().manual_seed(0))
    fused = models.create("resnet50", fused_eval=True, **kw)
    fused.load_state_dict(plain.state_dict())
    plain, fused = plain.eval().to(cuda), fused.eval().to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 256, 128, 3)).astype(np.float32))
    before = bn_mod.launches
    with torch.no_grad():
        a = plain(x.to(cuda))["embeddings"]
        b = fused(x.to(cuda))["embeddings"]
    torch.cuda.synchronize()
    assert bn_mod.launches == before + 12  # the 12 identity blocks of ResNet-50
    assert a.dtype == b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    assert float(((a - b).norm(dim=-1) / a.norm(dim=-1)).max()) <= 1e-4
