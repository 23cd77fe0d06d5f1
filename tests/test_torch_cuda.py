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
from ssg_tpu_torch.train.schedule import make_optimizer
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
