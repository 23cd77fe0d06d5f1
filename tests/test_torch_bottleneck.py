"""Port parity of the fused-eval path: ``fold_bn``, the folded bottleneck and
stage ops, and ``SSGResNet(fused_eval=True)``, against the JAX package on
the same numpy inputs (CPU). The port's CPU path is each kernel's plain
version; the CUDA kernel is held against it on a card by
``test_torch_cuda.py``. The JAX kernels run as their own tests run them on
the CPU: Pallas in interpret mode, or their XLA reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu import models as jax_models
from ssg_tpu.ops import bottleneck as jax_bn
from ssg_tpu.ops import bottleneck_stage as jax_stage

from ssg_tpu_torch import models
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.ops import bottleneck as bn_mod
from ssg_tpu_torch.ops.bottleneck import bottleneck_ref, fold_bn, fused_bottleneck
from ssg_tpu_torch.ops.bottleneck_stage import fused_bottleneck_stage, stage_ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(rng, c, cm, cout, ds=False):
    shapes = [(c, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    if ds:
        shapes += [(c, cout), (cout,)]
    return [(rng.normal(size=s) * 0.1).astype(np.float32) for s in shapes]


def _bn_stats(rng, n):
    return [rng.normal(size=n).astype(np.float32) * 0.1 + 1.0,  # scale
            rng.normal(size=n).astype(np.float32) * 0.1,        # bias
            rng.normal(size=n).astype(np.float32) * 0.5,        # mean
            rng.uniform(0.5, 1.5, size=n).astype(np.float32)]   # var


def test_fold_bn_matches_jax(rng):
    kern = rng.normal(size=(3, 3, 16, 24)).astype(np.float32)
    stats = _bn_stats(rng, 24)
    ours = fold_bn(_t(kern), *map(_t, stats))
    ref = jax_bn.fold_bn(jnp.asarray(kern), *map(jnp.asarray, stats))
    # Both fold in fp32 with the same formula; rsqrt may differ in its last bit.
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).astype(jnp.bfloat16).view(np.int16).astype(np.int32)


def _randomized_jax_variables(model, x, rng):
    v = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key in ("scale", "bias") else a), v["params"])
    return {"params": params, "batch_stats": stats}


def _pair(rng, stage_sizes, batch, fused_eval=True, dtype=torch.float32):
    kw = dict(stage_sizes=stage_sizes, num_features=0, num_parts=3)
    x = rng.normal(size=(batch, 64, 32, 3)).astype(np.float32)
    fm = jax_models.SSGResNet(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST,
                              fused_eval=fused_eval, **kw)
    variables = _randomized_jax_variables(fm, x, rng)
    tm = models.create("resnet50", fused_eval=fused_eval, dtype=dtype, **kw).eval()
    tm.load_state_dict(from_jax_variables(variables))
    return x, fm, variables, tm


def test_folded_bf16_weights_round_once(rng):
    """The bf16 model folds its fp32 masters and rounds once, as JAX's
    ``fold_bn(...).astype(bfloat16)``; folding a bf16-stored weight would
    round twice and miss on a large share of the entries."""
    _, _, variables, tm = _pair(rng, (2, 2), 1, dtype=torch.bfloat16)
    blk = tm.backbone.layer2[1]
    assert blk.conv2.weight.dtype == torch.float32  # the master
    assert tm.backbone.layer2[0].conv2.weight.dtype == torch.float32  # every conv keeps one
    ours = blk.folded(torch.bfloat16)
    p = variables["params"]["backbone"]["layer2_1"]
    s = variables["batch_stats"]["backbone"]["layer2_1"]
    for i, (cn, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))):
        stats = (p[bn]["scale"], p[bn]["bias"], s[bn]["mean"], s[bn]["var"])
        kern = p[cn]["kernel"]
        w, b = jax_bn.fold_bn(jnp.asarray(kern), *map(jnp.asarray, stats))
        w = w[0, 0] if cn != "conv2" else w
        want = _bf16_bits(w)
        got = ours[2 * i].view(torch.int16).numpy().astype(np.int32)
        # Equal, except where the fp32 fold sits on a bf16 rounding boundary
        # and a last-bit rsqrt difference tips it: then within 1 ulp.
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() <= 1e-3
        # The bias subtracts two terms of order 1 (bias - mean * s): a last-bit
        # rsqrt difference shows as ~1 fp32 ulp of 1, absolute.
        np.testing.assert_allclose(ours[2 * i + 1].numpy(), np.asarray(b), rtol=1e-6, atol=3e-7)
        # The double rounding this guards against.
        k16 = np.asarray(kern).astype(jnp.bfloat16).astype(np.float32)
        w2, _ = jax_bn.fold_bn(jnp.asarray(k16), *map(jnp.asarray, stats))
        twice = _bf16_bits(w2[0, 0] if cn != "conv2" else w2)
        assert (twice != want).mean() > 0.05


@pytest.mark.parametrize("b,h,w,c,cm", [(4, 8, 6, 64, 16), (2, 2, 1, 64, 16)])
def test_fused_bottleneck_matches_jax_fp32(rng, b, h, w, c, cm):
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ws = _block(rng, c, cm, c)
    ours = fused_bottleneck(_t(x), *map(_t, ws)).numpy()
    ref = np.asarray(jax_bn.bottleneck_ref(jnp.asarray(x), *map(jnp.asarray, ws)))
    kern = np.asarray(jax_bn.fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ws),
                                              interpret=True))
    assert ours.shape == ref.shape == (b, h, w, c)
    # fp32 throughout: products and sums in another order.
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, kern, rtol=0, atol=1e-5)


def test_fused_bottleneck_matches_jax_bf16(rng):
    x = jnp.asarray(rng.normal(size=(2, 8, 6, 64)).astype(np.float32)).astype(jnp.bfloat16)
    ws = _block(rng, 64, 16, 64)
    ref = jax_bn.fused_bottleneck(x, *map(jnp.asarray, ws), interpret=True)
    ours = fused_bottleneck(_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16),
                            *map(_t, ws))
    assert ours.dtype == torch.bfloat16
    # Both round y1, y2 and the output to bf16 and may flip a rounding where
    # fp32 sums are taken in another order: 4 ulps of max(|ref|, rms(ref)).
    assert bn_mod.bf16_ulp_error(ours, _t(np.asarray(ref.astype(jnp.float32)))) <= 4


def _stage_blocks(rng, c, cm, n_identity):
    return ([_block(rng, c, cm, 4 * cm, ds=True)]
            + [_block(rng, 4 * cm, cm, 4 * cm) for _ in range(n_identity)])


# Stride 1 and 2 at JAX's kernel test shape, and an odd-W stride-2 input
# (where the JAX op falls back to its reference).
@pytest.mark.parametrize("stride,h,w", [(1, 16, 8), (2, 16, 8), (2, 9, 7)])
def test_stage_matches_jax(rng, stride, h, w):
    blocks = _stage_blocks(rng, 16, 8, 2)
    x = rng.normal(size=(4, h, w, 16)).astype(np.float32)
    jblocks = tuple(tuple(map(jnp.asarray, blk)) for blk in blocks)
    ref = np.asarray(jax_stage.stage_ref(jnp.asarray(x), jblocks, stride))
    kern = np.asarray(jax_stage.fused_bottleneck_stage(jnp.asarray(x), jblocks, stride=stride,
                                                       interpret=True))
    tblocks = [tuple(map(_t, blk)) for blk in blocks]
    ours = fused_bottleneck_stage(_t(x), tblocks, stride).numpy()
    assert ours.shape == ref.shape == (4, (h - 1) // stride + 1, (w - 1) // stride + 1, 32)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, kern, rtol=0, atol=1e-5)
    np.testing.assert_allclose(stage_ref(_t(x), tblocks, stride).numpy(), ours, rtol=0, atol=0)


def test_bottleneck_ref_is_the_identity_stage(rng):
    ws = [_t(a) for a in _block(rng, 32, 8, 32)]
    x = _t(rng.normal(size=(2, 5, 3, 32)).astype(np.float32))
    torch.testing.assert_close(stage_ref(x, [ws], 2), bottleneck_ref(x, *ws), rtol=0, atol=0)


@pytest.mark.parametrize("stage_sizes,batch,atol", [((2, 2), 2, 1e-5), ((3, 4, 6, 3), 1, 2e-4)])
def test_fused_model_matches_jax_fp32(rng, stage_sizes, batch, atol):
    x, fm, variables, tm = _pair(rng, stage_sizes, batch)
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), train=False)["embeddings"])
    with torch.no_grad():
        ours = tm(_t(x))["embeddings"].numpy()
        unfused = models.create("resnet50", stage_sizes=stage_sizes, num_features=0,
                                num_parts=3).eval()
        unfused.load_state_dict(tm.state_dict())
        plain = unfused(_t(x))["embeddings"].numpy()
    assert ours.shape == ref.shape
    # fp32 sums in another order through the depth of the network (the
    # tolerances of tests/test_torch_model.py); fused against unfused within
    # JAX's own fused-vs-standard tolerance (tests/test_bottleneck.py).
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)
    np.testing.assert_allclose(ours, plain, rtol=0, atol=1e-4)


def test_fused_model_train_mode_unaffected(rng):
    _, _, _, fused = _pair(rng, (2, 2), 2)
    plain = models.create("resnet50", stage_sizes=(2, 2), num_features=0, num_parts=3)
    plain.load_state_dict(fused.state_dict())
    x = _t(rng.normal(size=(4, 64, 32, 3)).astype(np.float32))
    a = plain.train()(x)
    b = fused.train()(x)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    for (ka, va), (kb, vb) in zip(plain.state_dict().items(), fused.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka  # running statistics too


def test_fold_cache_follows_weights(rng):
    _, _, variables, tm = _pair(rng, (2, 2), 1)
    blk = tm.backbone.layer1[1]
    first = blk.folded(torch.float32)
    assert blk.folded(torch.float32) is first  # cached while nothing changes
    x = _t(rng.normal(size=(2, 64, 32, 3)).astype(np.float32))
    # New weights through load_state_dict (in-place copies): the fold follows.
    _, _, other, fresh = _pair(rng, (2, 2), 1)
    tm.load_state_dict(fresh.state_dict())
    assert blk.folded(torch.float32) is not first
    with torch.no_grad():
        torch.testing.assert_close(tm(x)["embeddings"], fresh(x)["embeddings"], rtol=0, atol=0)
        blk.bn2.running_var.mul_(2.0)  # an in-place change of one statistic
        changed = tm(x)["embeddings"]
    assert not torch.equal(changed, fresh(x)["embeddings"])
