"""Port parity of the data and model layers: transforms, the synthetic
renderer, the weight conversion and the SSG ResNet forward, against the JAX
package on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu import models as jax_models
from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.data import transforms as jax_transforms

from ssg_tpu_torch import models
from ssg_tpu_torch.data import datasets, transforms
from ssg_tpu_torch.models.convert import from_jax_variables


def test_test_transform_exact_for_uint8(rng):
    u = rng.integers(0, 256, size=(2, 256, 128, 3), dtype=np.uint8)
    ours = transforms.test_transform(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_transforms.test_transform(jnp.asarray(u))))
    bf = transforms.normalize(torch.from_numpy(u), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


# Up- and down-scaling, including odd factors. Tolerance 2e-4 on the 0..255
# pixel scale: fp32 interpolation weights summed in another order.
@pytest.mark.parametrize("src,dst", [((64, 32), (256, 128)), ((300, 150), (256, 128)),
                                     ((256, 128), (128, 64)), ((256, 128), (97, 45))])
def test_rect_scale(rng, src, dst):
    x = rng.uniform(0, 255, size=(2, *src, 3)).astype(np.float32)
    ours = transforms.rect_scale(torch.from_numpy(x), *dst).numpy()
    ref = np.asarray(jax_transforms.rect_scale(jnp.asarray(x), *dst))
    assert ours.shape == ref.shape == (2, *dst, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-4)


def test_test_transform_resizes(rng):
    u = rng.integers(0, 256, size=(2, 200, 100, 3), dtype=np.uint8)
    ours = transforms.test_transform(torch.from_numpy(u)).numpy()
    ref = np.asarray(jax_transforms.test_transform(jnp.asarray(u)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_synthetic_renderer_byte_identical():
    ours = datasets.create("market1501", scale="tiny", seed=3)
    ref = jax_datasets.create("market1501", scale="tiny", seed=3)
    assert (ours.train, ours.query, ours.gallery) == (ref.train, ref.query, ref.gallery)
    assert ours.num_train_ids == ref.num_train_ids
    fnames = [f for f, _, _ in (ours.train[:3] + ours.query[:2] + ours.gallery[-2:])]
    np.testing.assert_array_equal(ours.render(fnames), ref.render(fnames))
    with pytest.raises(KeyError):
        datasets.create("nope")


def _randomized_jax_variables(model, x, rng):
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = jax.tree.map(np.asarray, v)
    # Non-trivial BN statistics and affine terms, so their conversion counts.
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key in ("scale", "bias") else a), v["params"])
    return {"params": params, "batch_stats": stats}


def _pair(rng, stage_sizes, num_features, batch):
    kw = dict(stage_sizes=stage_sizes, num_features=num_features, num_parts=3)
    x = rng.normal(size=(batch, 64, 32, 3)).astype(np.float32)
    fm = jax_models.SSGResNet(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    variables = _randomized_jax_variables(fm, x, rng)
    tm = models.create("resnet50", **kw, dtype=torch.float32).eval()
    tm.load_state_dict(from_jax_variables(variables))  # strict: every key maps
    return x, fm, variables, tm


@pytest.mark.parametrize("num_features", [0, 16])
def test_model_fp32_parity_shallow(rng, num_features):
    x, fm, variables, tm = _pair(rng, (1, 1), num_features, batch=2)
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), train=False)["embeddings"])
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))["embeddings"].numpy()
    assert ours.shape == ref.shape == (3, 2, num_features or 512)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_model_resnet50_fp32_and_bf16(rng):
    x, fm, variables, tm = _pair(rng, (3, 4, 6, 3), 0, batch=1)
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), train=False)["embeddings"])
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))["embeddings"].numpy()
    assert ours.shape == (3, 1, 2048)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-4)

    # bf16 backbone against the fp32 model just held to JAX: per-row cosine
    # >= 0.99. At 128x64, not 64x32: there layer4's stride-2 3x3 conv sees a
    # 4x2 map, where PyTorch's CPU bf16 convolution (oneDNN, torch 2.13)
    # returns NaN or wrong values; the fp32 path and cuDNN are unaffected.
    tb = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16).eval()
    tb.load_state_dict(from_jax_variables(variables))
    # fp32 master weights, as Flax keeps its parameters; bf16 activations.
    assert tb.backbone.conv1.weight.dtype == torch.float32
    assert tb.backbone.bn1.weight.dtype == torch.float32
    x2 = torch.from_numpy(rng.normal(size=(2, 128, 64, 3)).astype(np.float32))
    with torch.no_grad():
        low = tb(x2)["embeddings"].numpy()
        high = tm(x2)["embeddings"].numpy()
    assert low.dtype == np.float32
    cos = (low * high).sum(-1) / (np.linalg.norm(low, axis=-1) * np.linalg.norm(high, axis=-1))
    assert cos.min() >= 0.99, cos


def test_model_reset_parameters_is_seeded():
    def make():
        m = models.create("resnet50", stage_sizes=(1, 1), num_features=8)
        return m.reset_parameters(torch.Generator().manual_seed(0)).eval()

    a, b = make(), make()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(KeyError):
        models.create("resnet9000")


def test_bf16_model_keeps_fp32_masters_and_computes_bf16(rng):
    tb = models.create("resnet50", stage_sizes=(1, 1), num_features=8, dtype=torch.bfloat16)
    assert {p.dtype for p in tb.parameters()} == {torch.float32}
    seen = {}
    for name, m in tb.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(
                lambda mod, args, out, name=name: seen.__setitem__(name, (args[0].dtype, out.dtype)))
    x = torch.from_numpy(rng.normal(size=(4, 128, 64, 3)).astype(np.float32))
    out = tb.train()(x)  # the stem and the downsample conv included
    assert len(seen) == 9 and set(seen.values()) == {(torch.bfloat16, torch.bfloat16)}, seen
    out["embeddings"].float().sum().backward()
    for p in tb.parameters():  # gradients reach the fp32 masters
        assert p.grad is not None and p.grad.dtype == torch.float32
    # An update smaller than half a bf16 ulp of the weight still lands.
    w = tb.backbone.conv1.weight
    before = w.detach().clone()
    with torch.no_grad():
        w.add_(before.abs() * 2.0**-12)
    assert not torch.equal(w, before)
    # The eval cast is cached until the master changes in place.
    tb.eval()
    with torch.no_grad():
        first = tb.backbone.conv1.cast_weight(torch.bfloat16)
        assert tb.backbone.conv1.cast_weight(torch.bfloat16) is first
        w.mul_(2.0)
        again = tb.backbone.conv1.cast_weight(torch.bfloat16)
        assert again is not first and torch.equal(again, w.to(torch.bfloat16))


# The classifier heads and dropout: logits in eval and train mode (dropout
# 0) against Flax, and from_jax_variables carrying ``classifier_*``.
@pytest.mark.parametrize("train", [False, True])
def test_classifier_heads_match_jax(rng, train):
    kw = dict(stage_sizes=(1, 1), num_features=16, num_parts=3, num_classes=7)
    x = rng.normal(size=(4, 64, 32, 3)).astype(np.float32)
    fm = jax_models.SSGResNet(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    variables = _randomized_jax_variables(fm, x, rng)
    sd = from_jax_variables(variables)
    assert sd["classifier_up.weight"].shape == (7, 16) and "classifier_down.bias" in sd
    tm = models.create("resnet50", dropout=0.0, **kw)
    tm.load_state_dict(sd)
    ref = fm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
    ref = ref[0] if train else ref
    with torch.no_grad():
        ours = tm.train(train)(torch.from_numpy(x))
    assert set(ours) == {"embeddings", "logits"}
    assert ours["logits"].shape == (3, 4, 7)
    # Train mode normalises by the batch: Flax's E[x^2] - E[x]^2 variance
    # costs it up to ~1e-4 there (tests/test_torch_train.py).
    atol = 2e-4 if train else 1e-5
    np.testing.assert_allclose(ours["logits"].numpy(), np.asarray(ref["logits"]), rtol=0, atol=atol)
    # Dropout feeds only the logits; the embedding is taken before it.
    drop = models.create("resnet50", dropout=0.5, **kw)
    drop.load_state_dict(sd)
    torch.manual_seed(0)
    with torch.no_grad():
        dropped = drop.train(train)(torch.from_numpy(x))
    torch.testing.assert_close(dropped["embeddings"], ours["embeddings"], rtol=0, atol=0)
    assert torch.equal(dropped["logits"], ours["logits"]) != train
