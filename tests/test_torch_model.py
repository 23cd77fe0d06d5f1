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
from ssg_tpu_torch.models.layers import cast_masters, derived_caches, no_hooks


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
        first = cast_masters(tb.backbone.conv1, torch.bfloat16)[0]
        assert cast_masters(tb.backbone.conv1, torch.bfloat16)[0] is first
        w.mul_(2.0)
        again = cast_masters(tb.backbone.conv1, torch.bfloat16)[0]
        assert again is not first and torch.equal(again, w.to(torch.bfloat16))


def test_derived_caches_are_the_casts_and_folds_held_now(rng):
    # A no-grad eval forward of a bf16 fused-eval model builds a fold of
    # each identity block and a cast of every other conv's master;
    # derived_caches lists exactly those objects. A train-mode forward drops
    # the folds (the blocks' own convs run and cast then), and a cast is
    # rebuilt once its master changes.
    tb = models.create("resnet50", stage_sizes=(2, 2), num_features=8, dtype=torch.bfloat16,
                       fused_eval=True)
    assert derived_caches(tb) == []
    x = torch.from_numpy(rng.normal(size=(2, 128, 64, 3)).astype(np.float32))
    with torch.no_grad():
        tb.eval()(x)
    idents = [tb.backbone.layer1[1], tb.backbone.layer2[1]]
    folded = {id(m) for b in idents for m in b.modules()}
    convs = [m for m in tb.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m._cast_cache is None for m in convs if id(m) in folded)
    casts = [m._cast_cache for m in convs if id(m) not in folded]
    folds = [b._fold_cache for b in idents]
    assert all(c is not None for c in casts + folds)
    got = derived_caches(tb)
    assert len(got) == len(casts) + 2
    assert {id(c) for c in got} == {id(c) for c in casts + folds}
    with torch.no_grad():
        tb.train()(x)
    ids = {id(c) for c in derived_caches(tb)}  # the identity blocks' convs cast now too
    assert all(id(c) in ids for c in casts) and not any(id(f) in ids for f in folds)
    with torch.no_grad():
        tb.backbone.conv1.weight.mul_(2.0)
        tb.eval()(x)
    ids = {id(c) for c in derived_caches(tb)}
    assert id(tb.backbone.conv1._cast_cache) in ids and id(casts[0]) not in ids


@pytest.mark.parametrize("kind", ["forward", "forward_pre", "backward", "backward_pre",
                                  "global_forward", "global_forward_pre", "global_backward"])
def test_no_hooks_sees_the_hooks_a_replay_would_skip(kind):
    # A hook on any module, or a global one, is seen; a module's backward
    # hooks only where the backward counts too. Once removed, none is.
    from torch.nn.modules import module as nn_module
    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=0)
    leaf = tm.backbone.layer1[0].conv2
    assert no_hooks(tm.modules()) and no_hooks(tm.modules(), backward=True)
    handle = {
        "forward": lambda: leaf.register_forward_hook(lambda m, a, o: None),
        "forward_pre": lambda: leaf.register_forward_pre_hook(lambda m, a: None),
        "backward": lambda: leaf.register_full_backward_hook(lambda m, gi, go: None),
        "backward_pre": lambda: leaf.register_full_backward_pre_hook(lambda m, go: None),
        "global_forward": lambda: nn_module.register_module_forward_hook(lambda m, a, o: None),
        "global_forward_pre": lambda: nn_module.register_module_forward_pre_hook(
            lambda m, a: None),
        "global_backward": lambda: nn_module.register_module_full_backward_hook(
            lambda m, gi, go: None),
    }[kind]()
    try:
        forward_seen = kind not in ("backward", "backward_pre")
        assert no_hooks(tm.modules()) is not forward_seen
        assert not no_hooks(tm.modules(), backward=True)
    finally:
        handle.remove()
    assert no_hooks(tm.modules()) and no_hooks(tm.modules(), backward=True)


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


# ---- stem_s2d and act_store (interface parity), the conversions, the
# JAX-named train transforms ------------------------------------------------

def test_stem_s2d_matches_jax_s2d_stem(rng):
    """With ``stem_s2d=True`` the port's stem (the canonical conv) equals
    JAX's ``stem_conv_apply(s2d=True)`` on the same (64, 3, 7, 7) master at
    64x32, and at an odd size, where JAX takes the canonical conv too.
    Tolerances as tests/test_models.py's."""
    from ssg_tpu.models.resnet import stem_conv_apply as jax_stem

    kernel = (rng.normal(size=(7, 7, 3, 64)) / np.sqrt(147)).astype(np.float32)  # HWIO
    stem = models.create("resnet50", stage_sizes=(1, 1), stem_s2d=True).backbone.conv1
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    for shape in ((2, 64, 32, 3), (1, 31, 17, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        with torch.no_grad():
            ours = stem(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        ref = np.asarray(jax_stem(jnp.asarray(x), jnp.asarray(kernel), jnp.float32,
                                  jax.lax.Precision.HIGHEST, s2d=True))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-4)


def test_stem_s2d_model_matches_jax_and_keeps_fp32_heads(rng):
    x, fm, variables, tm = _pair(rng, (1, 1), 0, batch=2)
    fs = jax_models.SSGResNet(stage_sizes=(1, 1), num_features=0, num_parts=3, stem_s2d=True,
                              dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(fs.apply(variables, jnp.asarray(x), train=False)["embeddings"])
    ts = models.create("resnet50", stage_sizes=(1, 1), num_features=0, num_parts=3,
                       stem_s2d=True).eval()
    ts.load_state_dict(tm.state_dict())  # the same canonical parameter
    with torch.no_grad():
        ours = ts(torch.from_numpy(x))["embeddings"].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # bf16 backbone: the stem computes in bf16, the heads stay fp32, and the
    # flag changes no value (at 128x64: the oneDNN bf16 gotcha of
    # test_model_resnet50_fp32_and_bf16).
    x2 = torch.from_numpy(rng.normal(size=(2, 128, 64, 3)).astype(np.float32))
    outs = []
    for s2d in (None, True):
        tb = models.create("resnet50", stage_sizes=(1, 1), num_features=0, num_parts=3,
                           dtype=torch.bfloat16, stem_s2d=s2d).eval()
        tb.load_state_dict(tm.state_dict())
        seen = []
        tb.backbone.conv1.register_forward_hook(lambda m, a, o: seen.append(o.dtype))
        with torch.no_grad():
            outs.append(tb(x2)["embeddings"])
        assert seen == [torch.bfloat16] and outs[-1].dtype == torch.float32
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_act_store_is_refused(arch):
    """``act_store`` is not ported: ``None`` builds the model, a dtype
    raises, naming the option, rather than building something else."""
    models.create(arch, stage_sizes=(1, 1), act_store=None)
    with pytest.raises(NotImplementedError, match="act_store"):
        models.create(arch, stage_sizes=(1, 1), act_store=torch.float8_e4m3fn)


def test_to_jax_variables_is_torch_to_flax_and_inverts_from_jax_variables(rng):
    from ssg_tpu.models.convert import flax_to_torch, torch_to_flax

    from ssg_tpu_torch.models.convert import to_jax_variables

    kw = dict(stage_sizes=(1, 1), num_features=16, num_parts=3, num_classes=7)
    x = rng.normal(size=(2, 64, 32, 3)).astype(np.float32)
    variables = _randomized_jax_variables(jax_models.SSGResNet(**kw), x, rng)
    tm = models.create("resnet50", **kw)
    tm.load_state_dict(from_jax_variables(variables))
    sd = tm.state_dict()

    ours, ref = to_jax_variables(sd), torch_to_flax(sd)
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # ... the variables the model was loaded from, back again.
    jax.tree.map(np.testing.assert_array_equal, ours, variables)

    back, ref_back = from_jax_variables(variables), flax_to_torch(variables)
    assert set(back) - set(ref_back) == {k for k in back if k.endswith("num_batches_tracked")}
    for k, arr in ref_back.items():
        np.testing.assert_array_equal(back[k].numpy(), arr)
    rt = from_jax_variables(to_jax_variables(sd))
    assert rt.keys() == sd.keys() and all(torch.equal(rt[k], sd[k]) for k in sd)


def test_jax_named_train_transforms_compose_draw_crops_and_crop_flip(rng):
    """``train_transform``, ``random_sized_rect_crop`` and
    ``random_horizontal_flip`` equal their ``draw_crops`` / ``crop_flip``
    compositions on the same generator, and ``train_transform`` equals the
    JAX package's arithmetic on the drawn boxes and flips."""
    u8 = torch.from_numpy(rng.integers(0, 256, size=(5, 48, 24, 3), dtype=np.uint8))

    def gen():
        return torch.Generator().manual_seed(3)

    boxes, flips = transforms.draw_crops(gen(), 5, 48, 24)
    want = transforms.normalize_float(transforms.crop_flip(u8, boxes, flips, 64, 32),
                                      torch.float32)
    got = transforms.train_transform(gen(), u8, 64, 32)
    assert torch.equal(got, want) and got.shape == (5, 64, 32, 3)
    assert transforms.train_transform(gen(), u8, 64, 32, dtype=torch.bfloat16).dtype == \
        torch.bfloat16

    no_flip = torch.zeros(5, dtype=torch.bool)
    assert torch.equal(transforms.random_sized_rect_crop(gen(), u8, 64, 32),
                       transforms.crop_flip(u8, boxes, no_flip, 64, 32))

    whole = torch.tensor([[0.0, 0.0, 48.0, 24.0]]).repeat(5, 1)
    assert torch.equal(transforms.random_horizontal_flip(gen(), u8.float()),
                       transforms.crop_flip(u8, whole, flips, 48, 24))

    # JAX's crop (scale_and_translate on each box), flip and normalisation.
    ref = []
    for img, (y0, x0, ch, cw), flip in zip(u8.numpy(), boxes.numpy(), flips.numpy()):
        r = jax.image.scale_and_translate(
            jnp.asarray(img, jnp.float32), (64, 32, 3), (0, 1),
            jnp.stack([64 / jnp.float32(ch), 32 / jnp.float32(cw)]),
            jnp.stack([-jnp.float32(y0) * 64 / ch, -jnp.float32(x0) * 32 / cw]), "bilinear")
        ref.append(r[:, ::-1] if flip else r)
    ref = (jnp.stack(ref) / 255.0 - jax_transforms.IMAGENET_MEAN) / jax_transforms.IMAGENET_STD
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
