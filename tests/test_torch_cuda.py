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
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.evaluation_metrics import accuracy, cmc, mean_ap
from ssg_tpu_torch.loss import OIMLoss
from ssg_tpu_torch.ops import bottleneck as bn_mod
from ssg_tpu_torch.ops import bottleneck_stage as stage_mod
from ssg_tpu_torch.ops import distance as dist_mod
from ssg_tpu_torch.ops import l1 as l1_mod
from ssg_tpu_torch.ops.bottleneck import bf16_ulp_error, bottleneck_ref, fused_bottleneck
from ssg_tpu_torch.ops.bottleneck_stage import fused_bottleneck_stage, stage_ref
from ssg_tpu_torch.ops.distance import pairwise_distance, pairwise_distance_ref
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref
from ssg_tpu_torch.utils import profiling
from ssg_tpu_torch.train.schedule import load_optimizer_state, make_optimizer, set_learning_rate
from ssg_tpu_torch.train.trainer import make_train_step

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
# largest output. A 3-block stage also runs the downsample block. The
# kernel's tiles are 128 pixels x 128 channels (64 where Cout <= 64 or K <=
# 128) over 32-deep K slabs: C 40 / Cm 24 put slab edges inside a tap of the
# 3x3 (K = 40, 216, 24); layer1's widths take the 64-wide tiles; B H W of
# 105, 129 and 130 pixels is ragged against 128.
FP32_REL = 1e-4


@pytest.mark.parametrize("b,h,w,c,cm", [(3, 5, 7, 32, 8), (2, 9, 13, 40, 8),
                                        (2, 16, 8, 1024, 256), (1, 8, 4, 2048, 512),
                                        (2, 9, 13, 40, 24), (1, 7, 5, 40, 24),
                                        (2, 64, 32, 256, 64), (1, 43, 3, 64, 16),
                                        (2, 5, 13, 72, 96), (3, 5, 7, 136, 40)])
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


# The fp32 downsample block alone: its stride-2 3x3 and strided 1x1 residual
# at the path's widths (layers 2-4, small maps), odd maps at stride 2, and
# layer1's stride-1 block.
@pytest.mark.parametrize("b,stride,h,w,c,cm,cout", [(2, 2, 16, 8, 256, 128, 512),
                                                    (2, 2, 16, 8, 512, 256, 1024),
                                                    (1, 2, 8, 4, 1024, 512, 2048),
                                                    (3, 2, 9, 7, 24, 8, 32),
                                                    (1, 2, 13, 11, 40, 16, 72),
                                                    (2, 1, 16, 8, 64, 64, 256)])
def test_downsample_block_fp32_matches_ref(gen, cuda, b, stride, h, w, c, cm, cout):
    x = _act(gen, (b, h, w, c), cuda).float()
    blk = tuple(t.float() for t in _weights(gen, c, cm, cout, True, cuda))
    before = stage_mod.launches
    out = fused_bottleneck_stage(x, [blk], stride)
    torch.cuda.synchronize()
    assert stage_mod.launches == before + 1
    ref = stage_ref(x, [blk], stride)
    assert out.shape == ref.shape == (b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= FP32_REL * float(ref.abs().max())


# The fp32 kernel's ring (4 slots, one block barrier a slab) and its
# epilogue staged in the ring: a slot refilled too early, or the tile
# staged before every warp left the last slab, would change bits from
# launch to launch. Three shapes, 50 launches each, the same bits.
@pytest.mark.parametrize("b,stride,h,w,c,cm,cout", [(8, 1, 32, 16, 256, 64, 256),
                                                    (8, 2, 16, 8, 512, 256, 1024),
                                                    (4, 1, 8, 4, 2048, 512, 2048)])
def test_fp32_kernel_same_bits_over_many_launches(gen, cuda, b, stride, h, w, c, cm, cout):
    ds = stride != 1 or cout != c
    x = _act(gen, (b, h, w, c), cuda).float()
    blk = tuple(t.float() for t in _weights(gen, c, cm, cout, ds, cuda))
    if ds:
        run, ref = (lambda: fused_bottleneck_stage(x, [blk], stride)), stage_ref(x, [blk], stride)
    else:
        run, ref = (lambda: fused_bottleneck(x, *blk)), bottleneck_ref(x, *blk)
    first = run()
    torch.cuda.synchronize()
    assert float((first - ref).abs().max()) <= FP32_REL * float(ref.abs().max())
    outs = [run() for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


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


# The kernel's operands arrive as tensor-map boxes: halo windows that cross
# every image edge and the tile edges inside an image (H and W not multiples
# of the tile; batches of 1-3, so the plan shrinks the tiles; a 130-wide map
# split into two column tiles), channels that are multiples of 8 but not of
# the 64-channel box (its tail reads the zero fill), a K of 9 Cm ending
# inside a box.
@pytest.mark.parametrize("b,h,w,c,cm", [(1, 11, 9, 64, 16), (2, 11, 9, 72, 24), (3, 7, 5, 40, 8),
                                        (1, 5, 130, 16, 8), (2, 13, 3, 136, 40),
                                        (1, 17, 6, 200, 56)])
def test_bottleneck_kernel_box_edges(gen, cuda, b, h, w, c, cm):
    x = _act(gen, (b, h, w, c), cuda)
    ws = _weights(gen, c, cm, c, False, cuda)
    out = fused_bottleneck(x, *ws)
    torch.cuda.synchronize()
    ref = bottleneck_ref(x, *ws)
    assert bool(torch.isfinite(out.float()).all())
    assert bf16_ulp_error(out, ref) <= BF16_ULPS


# The downsample instance alone (a stage of one block): odd H and W at
# stride 2, its strided residual box; channel counts off the 64-channel box;
# batches of 1-3.
@pytest.mark.parametrize("b,stride,h,w,c,cm,cout", [(1, 2, 13, 11, 40, 16, 72),
                                                    (3, 2, 9, 7, 24, 8, 32),
                                                    (2, 2, 17, 33, 72, 24, 104),
                                                    (2, 1, 11, 9, 64, 16, 64),
                                                    (1, 1, 5, 130, 16, 8, 32),
                                                    (3, 2, 16, 8, 1024, 512, 2048)])
def test_downsample_block_matches_ref(gen, cuda, b, stride, h, w, c, cm, cout):
    x = _act(gen, (b, h, w, c), cuda)
    blk = _weights(gen, c, cm, cout, True, cuda)
    out = fused_bottleneck_stage(x, [blk], stride)
    torch.cuda.synchronize()
    ref = stage_ref(x, [blk], stride)
    assert out.shape == ref.shape == (b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    assert bool(torch.isfinite(out.float()).all())
    assert bf16_ulp_error(out, ref) <= BF16_ULPS


# Phase 1 computes y1 in bands of whole halo rows, over strips of 16 rows: a
# 4 x 32 output tile's 6 x 34 halo window is two bands of 102 rows (112
# strip rows), at stride 2 a 9 x 65 window is nine bands of 65 (80). With C
# = 64 a band is one K chunk, so nothing orders one band's stores after the
# last one's; and the downsample kernel's blocks walk over several tiles.
# Every launch must give the same bits, within ulps of the plain version.
@pytest.mark.parametrize("stride,h,w,cm,cout,ds", [(1, 68, 32, 64, 256, True),
                                                   (2, 136, 64, 64, 256, True),
                                                   (1, 68, 32, 16, 64, False)])
def test_bottleneck_kernel_bands_over_many_launches(gen, cuda, stride, h, w, cm, cout, ds):
    b, c = 8, 64
    tile = bn_mod.plan(b, h, w, cm, stride, downsample=ds)
    assert (tile["tile_rows"], tile["tile_cols"]) == (4, 32)
    x = _act(gen, (b, h, w, c), cuda)
    blk = _weights(gen, c, cm, cout, ds, cuda)
    if ds:
        run, ref = (lambda: fused_bottleneck_stage(x, [blk], stride)), stage_ref(x, [blk], stride)
    else:
        run, ref = (lambda: fused_bottleneck(x, *blk)), bottleneck_ref(x, *blk)
    first = run()
    torch.cuda.synchronize()
    assert bf16_ulp_error(first, ref) <= BF16_ULPS
    for _ in range(50):
        assert torch.equal(run(), first)


def test_bottleneck_kernel_rejects_misaligned_input(gen, cuda):
    # Tensor maps need 16-byte aligned bases: a contiguous view 2 bytes in
    # raises in the wrapper, for x and for a weight.
    c, cm = 64, 16
    ws = _weights(gen, c, cm, c, False, cuda)
    flat = torch.zeros(2 * 4 * 4 * c + 1, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(2, 4, 4, c)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    with pytest.raises(ValueError):
        fused_bottleneck(x, *ws)
    w1 = torch.zeros(c * cm + 1, dtype=torch.bfloat16, device=cuda)[1:].view(c, cm)
    with pytest.raises(ValueError):
        fused_bottleneck(_act(gen, (2, 4, 4, c), cuda), w1, *ws[1:])


def test_fused_eval_follows_refolded_weights(cuda):
    # Launches before and after the weights change in place (the fold cache
    # refolds, and the caching allocator may hand the new folded tensors the
    # old addresses): each launch computes with the weights of its time.
    kw = dict(num_features=0, num_parts=3, dtype=torch.bfloat16, stage_sizes=(2,))
    model = models.create("resnet50", fused_eval=True, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.eval().to(cuda, memory_format=torch.channels_last)
    blk = model.backbone.layer1[1]
    x = _act(np.random.default_rng(3), (2, 16, 8, 256), cuda)
    for step in range(3):
        if step:
            with torch.no_grad():
                blk.conv2.weight.mul_(-1.5)
                blk.bn3.running_mean.add_(0.25)
        folded = blk.folded(torch.bfloat16)
        with torch.no_grad():
            out = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        assert bf16_ulp_error(out, bottleneck_ref(x, *folded)) <= BF16_ULPS


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


# ---- the training and evaluation surface on the card ------------------------------

def test_metrics_card_matches_cpu(gen, cuda):
    # Quantised distances (many ties, ranked in gallery order by the stable
    # sort): first-match curves and accuracy exact, allshots and mAP within
    # 1e-6 (fp32 sums in another order); single_gallery_shot exact where
    # each identity has one valid gallery image, so the draw decides nothing.
    q_ids, g_ids = gen.integers(0, 30, 120), gen.integers(0, 30, 500)
    q_cams, g_cams = gen.integers(0, 4, 120), gen.integers(0, 4, 500)
    dist = (gen.integers(0, 16, (120, 500)) / 4.0).astype(np.float32)
    args = (dist - (q_ids[:, None] == g_ids[None, :]), q_ids, g_ids, q_cams, g_cams)
    for sep in (False, True):
        for fmb in (False, True):
            kw = dict(topk=150, separate_camera_set=sep, first_match_break=fmb)
            card, cpu = cmc(*args, device=cuda, **kw), cmc(*args, device="cpu", **kw)
            np.testing.assert_allclose(card, cpu, rtol=0, atol=0.0 if fmb else 1e-6)
    assert mean_ap(*args) == pytest.approx(mean_ap(*args, device="cpu"), rel=0, abs=1e-6)
    logits = gen.integers(0, 3, (64, 10)).astype(np.float32)
    target = gen.integers(0, 10, 64)
    assert accuracy(logits, target, (1, 5)) == accuracy(logits, target, (1, 5), device="cpu")
    single = (gen.normal(size=(24, 12)).astype(np.float32), np.arange(12).repeat(2),
              np.arange(12), np.zeros(24, int), np.ones(12, int))
    for fmb in (False, True):
        kw = dict(topk=10, single_gallery_shot=True, first_match_break=fmb)
        np.testing.assert_array_equal(cmc(*single, **kw), cmc(*single, device="cpu", **kw))


def test_oim_loss_defaults_to_the_card(gen, cuda):
    oim = OIMLoss(8, 10)
    assert oim.lut.device.type == "cuda"
    feats = torch.nn.functional.normalize(torch.from_numpy(gen.normal(size=(6, 8))).float(), dim=1)
    labels = torch.tensor([1, 1, 4, -1, 7, 4])
    loss = oim(feats.to(cuda), labels.to(cuda))
    assert bool(torch.isfinite(loss))
    norms = oim.lut.norm(dim=1).cpu()
    assert torch.allclose(norms[[1, 4, 7]], torch.ones(3), atol=1e-6)
    assert not bool(oim.lut.cpu()[[0, 2, 3, 5, 6, 8, 9]].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_step_equals_plain_step_on_card(gen, cuda, dtype, monkeypatch):
    # The same step with and without remat, from the same weights, crops
    # and dropout draws, on the card: the recomputation runs the same
    # kernels, so loss, gradients and BatchNorm statistics are equal bit for
    # bit. cuDNN's fp32 weight gradients may differ from run to run in the
    # last bits (the order of their sums), so its deterministic ones are used.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(stage_sizes=(1, 1), num_features=16, num_classes=4, dropout=0.3, dtype=dtype)
    plain = models.create("resnet50", **kw).reset_parameters(torch.Generator().manual_seed(0))
    remat = models.create("resnet50", **kw)
    remat.load_state_dict(plain.state_dict())
    images = torch.from_numpy(gen.integers(0, 256, size=(8, 128, 64, 3), dtype=np.uint8))
    labels = torch.from_numpy(np.stack([np.repeat(np.arange(2), 4)] * 4))
    crops = transforms.draw_crops(torch.Generator(device=cuda).manual_seed(1), 8, 128, 64)
    losses = []
    for model, on in ((plain, False), (remat, True)):
        model.to(cuda, memory_format=torch.channels_last)
        step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), num_parts=3,
                               ce_weight=0.5, height=128, width=64, remat=on)
        torch.manual_seed(5)  # the dropout draws
        losses.append(float(step(images.to(cuda), labels.to(cuda), crops=crops)["loss"]))
    assert losses[1] == losses[0]
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(q.grad, p.grad), (name, float((q.grad - p.grad).abs().max()))
    remat_state = remat.state_dict()
    for name, t in plain.state_dict().items():
        assert torch.equal(remat_state[name], t), name


# ---- the graphed train step ---------------------------------------------------------

def _graph_twins(cuda, lr=1e-3, stage_sizes=(1, 1), fused_eval=False, dropout=0.0, oim=False,
                 **step_kw):
    # Two copies of a small SSG ResNet with the same weights on the card, each
    # with its own capturable AdamW and step: the first graphed, the second
    # kept eager by a forward pre-hook that does nothing.
    kw = dict(stage_sizes=stage_sizes, num_features=16, num_classes=4, dropout=dropout,
              dtype=torch.bfloat16, fused_eval=fused_eval)
    base = models.create("resnet50", **kw).reset_parameters(torch.Generator().manual_seed(0))
    twins = []
    for graphed in (True, False):
        model = models.create("resnet50", **kw)
        model.load_state_dict(base.state_dict())
        model.to(cuda, memory_format=torch.channels_last)
        if not graphed:
            model.register_forward_pre_hook(lambda mod, args: None)
        opt = make_optimizer(model.parameters(), lr)
        assert all(g["capturable"] for g in opt.param_groups)
        if oim:
            step_kw = dict(step_kw, oim_weight=1.0,
                           lut=torch.zeros((4, 16), dtype=torch.float32, device=cuda))
        step = make_train_step(model, opt, num_parts=3, height=128, width=64, **step_kw)
        twins.append((model, opt, step, step_kw.get("lut")))
    return twins


def _graph_batches(gen, cuda, steps):
    labels = np.stack([np.repeat(np.arange(4), 2)] * 3 + [np.repeat([0, 1, -1, 3], 2)])
    return [(torch.from_numpy(gen.integers(0, 256, size=(8, 128, 64, 3), dtype=np.uint8)).to(cuda),
             torch.from_numpy(labels).to(cuda)) for _ in range(steps)]


def _run_steps(step, batches, lr_after=None, opt=None):
    # The steps on one crop generator and one dropout stream; optionally a
    # new learning rate after the first half. Returns the outputs and the
    # graph replays counted.
    crops = torch.Generator(device=batches[0][0].device).manual_seed(1)
    torch.manual_seed(5)
    outs = []
    with profiling.record_spans():
        for i, (x, y) in enumerate(batches):
            if lr_after is not None and i == len(batches) // 2:
                set_learning_rate(opt, lr_after)
            outs.append(step(x, y, crops))
        torch.cuda.synchronize()
    return outs, profiling.recorded().counters.get("train.graph_replays", 0)


def _same(a, b, what):
    # Bit for bit: a replay runs the eager step's kernels on the same inputs.
    assert torch.equal(a, b), (what, float((a.double() - b.double()).abs().max()))


def _assert_same_training(graphed, eager, outs_g, outs_e):
    (mg, og, _, lut_g), (me, oe, _, lut_e) = graphed, eager
    _same(torch.stack([o["loss"] for o in outs_g]), torch.stack([o["loss"] for o in outs_e]),
          "losses")
    _same(torch.stack([o["prec"] for o in outs_g]), torch.stack([o["prec"] for o in outs_e]),
          "precs")
    for (name, p), q in zip(mg.named_parameters(), me.parameters()):
        _same(p.detach(), q.detach(), name)
        state = og.state.get(p, {})  # none for a parameter no loss reaches
        assert state.keys() == oe.state.get(q, {}).keys(), name
        for k, v in state.items():  # the AdamW moments and step count
            _same(v, oe.state[q][k], f"{name} {k}")
    for (name, t), u in zip(mg.named_buffers(), me.buffers()):
        _same(t, u, name)  # the BatchNorm running statistics
    if lut_g is not None:
        _same(lut_g, lut_e, "OIM table")


@pytest.mark.parametrize("variant", ["plain", "ce", "oim"])
def test_graphed_step_equals_eager_step_on_card(gen, cuda, variant, monkeypatch):
    # Six steps of the same model from the same weights, crops and dropout
    # draws: the first eager on both, the second captured and replayed once,
    # then replays. cuDNN's deterministic kernels, as in the remat test.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = {"plain": {}, "ce": dict(ce_weight=0.5, dropout=0.3), "oim": dict(oim=True)}[variant]
    graphed, eager = _graph_twins(cuda, **kw)
    batches = _graph_batches(gen, cuda, 6)
    outs_g, replays = _run_steps(graphed[2], batches)
    outs_e, none = _run_steps(eager[2], batches)
    assert (replays, none) == (5, 0)
    _assert_same_training(graphed, eager, outs_g, outs_e)


def test_graphed_step_returns_each_call_its_own_loss(gen, cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graphed, eager = _graph_twins(cuda)
    batches = _graph_batches(gen, cuda, 10)
    outs_g, replays = _run_steps(graphed[2], batches)
    outs_e, _ = _run_steps(eager[2], batches)
    assert replays == 9
    for key in ("loss", "prec"):
        assert len({o[key].data_ptr() for o in outs_g}) == 10, key
    losses = torch.stack([o["loss"] for o in outs_g])
    assert len(set(losses.tolist())) == 10
    _same(losses, torch.stack([o["loss"] for o in outs_e]), "losses")


def test_graphed_steps_leave_no_stale_cast_or_fold(gen, cuda, monkeypatch):
    # An extract with fused_eval before and after graphed steps: the replays
    # change the weights and BatchNorm statistics behind the cached casts and
    # folds, which must see it. The extract after them equals a fresh model's
    # with the same state and the eager twin's.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    twins = _graph_twins(cuda, lr=1e-2, stage_sizes=(2, 2), fused_eval=True)
    batches = _graph_batches(gen, cuda, 4)
    images = batches[0][0].cpu().numpy()
    feed = [(images, np.zeros(8), np.zeros(8), np.ones(8, dtype=bool))]
    feats = []
    for model, _, step, _ in twins:
        before = api.extract_features(model, feed, device=cuda)[0]
        _run_steps(step, batches)
        feats.append((before, api.extract_features(model, feed, device=cuda)[0]))
    model = twins[0][0]
    fresh = models.create("resnet50", stage_sizes=(2, 2), num_features=16, num_classes=4,
                          dtype=torch.bfloat16, fused_eval=True)
    fresh.load_state_dict(model.state_dict())
    fresh.to(cuda, memory_format=torch.channels_last)
    (before, after), (_, after_eager) = feats
    assert float((after - before).abs().max()) > 1e-2  # the steps moved the features
    _same(after, api.extract_features(fresh, feed, device=cuda)[0], "fresh model")
    _same(after, after_eager, "eager twin")


def test_graphed_step_recaptures_a_new_learning_rate(gen, cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graphed, eager = _graph_twins(cuda)
    batches = _graph_batches(gen, cuda, 6)
    outs_g, replays = _run_steps(graphed[2], batches, lr_after=3e-3, opt=graphed[1])
    outs_e, _ = _run_steps(eager[2], batches, lr_after=3e-3, opt=eager[1])
    assert replays == 4  # steps 2-3, then 5-6: step 4 runs the new rate eager
    _assert_same_training(graphed, eager, outs_g, outs_e)


@pytest.mark.parametrize("case", ["graphed", "hook", "remat", "cpu"])
def test_graphed_step_engages_only_where_it_can(gen, cuda, case):
    device = torch.device("cpu") if case == "cpu" else cuda
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(device)
    if case == "hook":
        model.backbone.layer1.register_forward_hook(lambda mod, args, out: None)
    opt = make_optimizer(model.parameters(), 1e-3)
    assert opt.param_groups[0]["capturable"] == (case != "cpu")
    step = make_train_step(model, opt, num_parts=3, height=128, width=64,
                           remat=case == "remat")
    batches = [(x.to(device), y[:3].to(device)) for x, y in _graph_batches(gen, cuda, 4)]
    crops = torch.Generator(device=device).manual_seed(1)
    with profiling.record_spans():
        losses = [float(step(x, y, crops)["loss"]) for x, y in batches]
    assert np.isfinite(losses).all()
    assert profiling.recorded().counters.get("train.graph_replays", 0) == (
        3 if case == "graphed" else 0)


def test_load_optimizer_state_moves_host_counters_to_the_card(cuda):
    # A checkpoint written on the CPU (not capturable, counters on the host)
    # resumes on the card as the card's capturable optimizer, and its next
    # step is the one the CPU takes.
    p = torch.ones(3, requires_grad=True)
    opt = make_optimizer([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    q = p.detach().to(cuda).requires_grad_()
    resumed = make_optimizer([q], 1e-3)
    load_optimizer_state(resumed, opt.state_dict())
    assert resumed.param_groups[0]["capturable"] is True
    p.grad, q.grad = torch.full((3,), 0.5), torch.full((3,), 0.5, device=cuda)
    opt.step()
    resumed.step()
    assert resumed.state[q]["step"].device.type == "cuda"
    assert float(resumed.state[q]["step"]) == 2.0
    torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-6, atol=0)


# ---- the graphed extract -----------------------------------------------------------

def _extract_twins(cuda, arch="resnet50", **kw):
    # Two copies of one model with the same weights on the card: the first
    # extracts through the graph, the second eagerly (a forward pre-hook that
    # does nothing keeps it off the graph).
    base = models.create(arch, **kw).reset_parameters(torch.Generator().manual_seed(0))
    twins = []
    for graphed in (True, False):
        model = models.create(arch, **kw)
        model.load_state_dict(base.state_dict())
        model.to(cuda, memory_format=torch.channels_last)
        if not graphed:
            model.register_forward_pre_hook(lambda mod, args: None)
        twins.append(model)
    return twins


def _extract_feed(gen, sizes, h=128, w=64):
    # Host batches of the sizes given, as a Preprocessor yields them (a
    # smaller last one is ragged); the test transform resizes them.
    return [(gen.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8), np.arange(n),
             np.zeros(n), np.ones(n, dtype=bool)) for n in sizes]


def _extract(model, feed, cuda):
    # The features of one extract and the batches it replayed.
    with profiling.record_spans():
        feats = api.extract_features(model, feed, device=cuda)[0]
        torch.cuda.synchronize()
    return feats, profiling.recorded().counters.get(api.EXTRACT_GRAPH_REPLAYS, 0)


@pytest.mark.parametrize("arch,kw", [
    ("resnet50", dict(stage_sizes=(2, 2), fused_eval=False)),
    ("resnet50", dict(stage_sizes=(2, 2), fused_eval=True)),
    ("inception", dict(depth=3, width=16)),
])
def test_graphed_extract_equals_eager_extract(gen, cuda, arch, kw, monkeypatch):
    # Two calls over four batches of 8 and a ragged one of 5: in the first
    # the first batch runs eager, the second captures and replays, the next
    # two replay; the ragged batch runs eager and leaves the graph to the
    # second call, which replays all four. Bit for bit the eager twin's, and
    # the first call's features are its own after the second.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graphed, eager = _extract_twins(cuda, arch, num_features=16, dtype=torch.bfloat16, **kw)
    feed = _extract_feed(gen, (8, 8, 8, 8, 5))
    firsts = []
    for want_replays in (3, 4):
        got, replays = _extract(graphed, feed, cuda)
        want, none = _extract(eager, feed, cuda)
        assert (replays, none) == (want_replays, 0)
        assert got.shape == (3, 37, 16)
        _same(got, want, "features")
        firsts.append(got)
    _same(firsts[0], firsts[1], "the first call's features after the second")


@pytest.mark.parametrize("change", ["graphed_steps", "load_state_dict", "bn_statistics"])
def test_graphed_extract_follows_new_weights(gen, cuda, change, monkeypatch):
    # An extract before and after the weights change: graphed train steps
    # (their replays bump the versions), load_state_dict, or a train-mode
    # forward, which moves only the BatchNorm statistics and drops the
    # fused-eval folds. The call after the change runs its first batch eager
    # and captures anew, and equals a fresh model's eager extract of the same
    # state.
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(stage_sizes=(2, 2), num_features=16, num_classes=4, dtype=torch.bfloat16,
              fused_eval=True)
    model, _, step, _ = _graph_twins(cuda, lr=1e-2, stage_sizes=(2, 2), fused_eval=True)[0]
    feed = _extract_feed(gen, (8, 8, 8))
    before, replays = _extract(model, feed, cuda)
    assert replays == 2
    if change == "graphed_steps":
        _run_steps(step, _graph_batches(gen, cuda, 4))
    elif change == "load_state_dict":
        other = models.create("resnet50", **kw).reset_parameters(torch.Generator().manual_seed(1))
        model.load_state_dict(other.state_dict())
    else:
        with torch.no_grad():
            model.train()(transforms.test_transform(torch.from_numpy(feed[0][0]).to(cuda)))
    after, replays = _extract(model, feed, cuda)
    assert replays == 2
    fresh = models.create("resnet50", **kw)
    fresh.load_state_dict(model.state_dict())
    fresh.to(cuda, memory_format=torch.channels_last)
    fresh.register_forward_pre_hook(lambda mod, args: None)
    want, none = _extract(fresh, feed, cuda)
    assert none == 0
    assert not torch.equal(after, before)  # the change moved the features
    _same(after, want, "fresh model")


def test_extract_with_a_hook_stays_eager(gen, cuda):
    # A forward hook would be skipped by a replay: the model runs eager, the
    # hook fires on every batch of every call and nothing replays.
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(cuda)
    rows = []
    block = model.backbone.layer1[0]  # the backbone calls its blocks, not the stage
    block.register_forward_hook(lambda mod, args, out: rows.append(out.shape[0]))
    feed = _extract_feed(gen, (8, 8, 8))
    for _ in range(2):
        feats, replays = _extract(model, feed, cuda)
        assert replays == 0 and bool(torch.isfinite(feats).all())
    assert rows == [8] * 6


def test_extract_under_autocast_stays_eager(gen, cuda):
    # Inside torch.autocast a capture would bake in autocast's casts and
    # their cache: every batch runs eager and nothing replays. Outside it the
    # same model captures on its second batch and replays from then on.
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(cuda)
    feed = _extract_feed(gen, (8, 8, 8))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        feats, replays = _extract(model, feed, cuda)
    assert replays == 0 and bool(torch.isfinite(feats).all())
    assert model not in api._eval_graphs
    assert _extract(model, feed, cuda)[1] == 2


def _clustered(gen, n, ids, dim):
    centers = gen.normal(size=(ids, dim))
    x = centers[np.sort(gen.integers(0, ids, n))] + 0.3 * gen.normal(size=(n, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_cluster_share(a, b):
    # The share of points whose cluster (noise alone) is the same set of
    # points in both labelings: renumbering does not count.
    same = 0
    for i in range(a.shape[0]):
        ca = {j for j in np.flatnonzero(a == a[i])} if a[i] >= 0 else {i}
        cb = {j for j in np.flatnonzero(b == b[i])} if b[i] >= 0 else {i}
        same += ca == cb
    return same / a.shape[0]


def test_streaming_cluster_matches_dense_on_card(gen, cuda):
    # Streaming against the dense chain on the card at a few thousand
    # points. Each computes its own distance products (chunked against
    # whole), which may swap near-tied neighbours, so the gate is path 1's:
    # 99.9 % of points in the same cluster, equal counts, eps within 1e-5.
    from ssg_tpu_torch.parallel import streaming_cluster

    x = torch.from_numpy(_clustered(gen, 3000, 130, 64)).to(cuda)
    kw = dict(k1=20, k2=6, lambda_value=0.1, rho=1.6e-3, min_samples=4)
    dense = api.cluster_groups(x[None], **kw)
    for band_cap in (None, 0):
        diag = {}
        before = l1_mod.launches
        labels, n_clusters, eps = streaming_cluster(x, chunk=512, band_cap=band_cap, diag=diag,
                                                    **kw)
        assert l1_mod.launches > before  # the sample (and the fallbacks) ran the kernel
        if band_cap == 0:
            assert diag["band_fallback"] and diag["fallback_code"] & 1
        assert n_clusters == dense[1][0] > 0
        assert abs(eps - dense[2][0]) <= 1e-5 * dense[2][0]
        assert _same_cluster_share(labels, dense[0][0]) >= 0.999


def test_streaming_rerank_eval_matches_dense_on_card(gen, cuda):
    from ssg_tpu_torch.ops.metrics import evaluate_rank
    from ssg_tpu_torch.parallel import streaming_rerank_eval

    ids = gen.integers(0, 150, 2600)
    cams = gen.integers(0, 6, 2600)
    centers = gen.normal(size=(150, 16))
    x = centers[ids] + 0.6 * gen.normal(size=(2600, 16))
    x = torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
    qf, gf = x[:400].to(cuda), x[400:].to(cuda)
    got_map, got_cmc, nv = streaming_rerank_eval(qf, gf, ids[:400], ids[400:], cams[:400],
                                                 cams[400:])
    full = api.re_ranking(features=torch.cat([qf, gf]))
    want = evaluate_rank(full[:400, 400:], *(torch.from_numpy(a).to(cuda) for a in
                                             (ids[:400], ids[400:], cams[:400], cams[400:])))
    assert nv > 0
    assert abs(got_map - float(want["mAP"])) <= 1e-4
    assert np.abs(got_cmc[:10] - want["cmc"][:10].cpu().numpy()).max() <= 2.0 / 400


def test_l1_kernel_general_path_on_a_streaming_tile(gen, cuda):
    # One 512-row chunk of a V-like matrix against the whole of it: the
    # general (x is not y) launch the streaming sweeps make.
    n = 4096
    cols = torch.from_numpy(gen.integers(0, n, (n, 54))).to(cuda)
    v = torch.zeros((n, n), device=cuda).scatter_add_(
        1, cols, torch.from_numpy(gen.random((n, 54)).astype(np.float32)).to(cuda))
    v /= v.sum(1, keepdim=True)
    before = l1_mod.launches
    out = l1_distance(v[:512], v)
    torch.cuda.synchronize()
    assert l1_mod.launches == before + 1
    ref = l1_distance_ref(v[:512], v)
    assert float((out - ref).abs().max()) <= 1e-5 * 2.0


def test_bound_product_is_sound_on_card(gen, cuda):
    # The screening bound with cuBLAS's fp32-output bf16 product: at or
    # below the exact re-ranked distance for every pair, near-duplicate
    # rows included.
    from ssg_tpu_torch.ops import minsum

    n, width = 512, 2048
    v = np.zeros((n, width), np.float32)
    for i in range(n):
        idx = gen.choice(width, size=gen.integers(1, 80), replace=False)
        w = gen.random(idx.size).astype(np.float32) + 1e-3
        v[i, idx] = w / w.sum()
    v[1] = v[0]
    v[3] = v[2] * np.float32(1 + 1e-7)
    vt = torch.from_numpy(v).to(cuda)
    g = minsum.bound_product(minsum.support_mask(vt), vt)
    assert g.dtype == torch.float32
    orig = torch.from_numpy(gen.random((n, n)).astype(np.float32)).to(cuda)
    fd_lb = minsum.fd_lower(minsum.minsum_upper(g), orig, 0.1).double().cpu().numpy()
    vd = torch.from_numpy(v).double()
    ms = torch.stack([torch.minimum(vd[i], vd).sum(1) for i in range(n)]).numpy()
    fd = np.maximum((1.0 - ms / (2.0 - ms)) * 0.9 + orig.double().cpu().numpy() * 0.1, 0.0)
    assert (fd_lb <= fd + 1e-6).all(), (fd_lb - fd).max()


def test_disk_decode_feeds_the_card_extract(gen, cuda, tmp_path):
    # A prepared tree of PPM files decoded by whichever decoder this machine
    # has (the native library, or PIL where it cannot be built), its
    # Preprocessor stream extracted on the card: equal to the extract of
    # the same pixels handed over in memory, in the same batches.
    from ssg_tpu_torch.data import Preprocessor, datasets

    images = tmp_path / "images"
    images.mkdir()
    pixels = gen.integers(0, 256, size=(20, 256, 128, 3), dtype=np.uint8)
    items = []
    for i, img in enumerate(pixels):
        name = f"{i // 4:08d}_{i % 2:02d}_{i:04d}.jpg"
        with open(images / name, "wb") as f:
            f.write(b"P6\n128 256\n255\n" + img.tobytes())
        items.append([name, i // 4, i % 2])
    (tmp_path / "splits.json").write_text(
        '[{"train": %s, "query": [], "gallery": []}]' % str(items).replace("'", '"'))
    ds = datasets.create("x", root=str(tmp_path))
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=0, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(cuda,
                                                                memory_format=torch.channels_last)
    disk = api.extract_features(model, Preprocessor(ds, batch_size=8))[0]
    batches = []
    for s in range(0, 20, 8):
        chunk = np.concatenate([pixels[s:s + 8], np.repeat(pixels[min(s + 8, 20) - 1:][:1],
                                                           max(s + 8 - 20, 0), 0)])
        batches.append((torch.from_numpy(chunk).to(cuda), np.zeros(8), np.zeros(8),
                        np.arange(8) < 20 - s))
    mem = api.extract_features(model, batches)[0]
    assert disk.device.type == "cuda" and disk.shape == (3, 20, 512)
    assert torch.equal(disk, mem)


def test_kissme_card_matches_cpu(gen, cuda):
    # fp32 covariances, inverses and eigendecomposition on the card (TF32
    # off) against the same fit on the CPU: M, L L^T and the distances
    # within 1e-4 of their largest entry, as the CPU tests hold the port
    # to JAX on well-conditioned 64-d covariances.
    from ssg_tpu_torch.metric_learning import KISSME

    y = gen.integers(0, 30, 800)
    x = (gen.normal(size=(800, 64)) + gen.normal(size=(30, 64))[y]).astype(np.float32)
    card = KISSME().fit(torch.from_numpy(x).to(cuda), y)
    cpu = KISSME().fit(x, y, device="cpu")
    assert card.M_.device.type == "cuda"
    scale = float(cpu.M_.abs().max())
    assert float((card.M_.cpu() - cpu.M_).abs().max()) <= 1e-4 * scale
    assert float(((card.L_ @ card.L_.T).cpu() - cpu.M_).abs().max()) <= 1e-4 * scale
    d_card, d_cpu = card.distance(x[:100]).cpu(), cpu.distance(x[:100])
    assert float((d_card - d_cpu).abs().max()) <= 1e-4 * float(d_cpu.abs().max())
