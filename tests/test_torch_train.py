"""Port parity of the training layer, against the JAX package on the same
numpy inputs (CPU): the train transform, the P x K sampler and prefetch,
the batch-hard triplet, the train-mode forward and its BatchNorm
statistics, the full loss's gradients, AdamW, the SSG++ term, the fold
cache under training, checkpoints and ``run_ssg``.

Shallow bottleneck models (``stage_sizes=(1, 1)``), 64x32 inputs, fp32 with
JAX at ``Precision.HIGHEST``; both packages hold the same weights through
``from_jax_variables``. The random streams differ (``jax.random`` against
``torch.Generator``), so crops are passed to both explicitly and the draws
are checked for their distribution."""

import copy
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import normalization as flax_normalization

from ssg_tpu import models as jax_models
from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.data.prefetch import prefetch as jax_prefetch
from ssg_tpu.data.sampler import RandomIdentitySampler as JaxSampler
from ssg_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ssg_tpu.ops.triplet import batch_hard_triplet_loss as jax_triplet
from ssg_tpu.train import semi as jax_semi
from ssg_tpu.train.schedule import lr_at as jax_lr_at
from ssg_tpu.train.schedule import make_optimizer as jax_make_optimizer
from ssg_tpu.train.ssg_loop import SSGConfig as JaxConfig
from ssg_tpu.train.ssg_loop import join_rule as jax_join_rule
from ssg_tpu.train.ssg_loop import run_ssg as jax_run_ssg

from ssg_tpu_torch import api, models
from ssg_tpu_torch.data import datasets, transforms
from ssg_tpu_torch.data.prefetch import prefetch
from ssg_tpu_torch.data.sampler import RandomIdentitySampler
from ssg_tpu_torch.loss import TripletLoss
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.parallel import Mesh
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss
from ssg_tpu_torch.train import semi
from ssg_tpu_torch.train.schedule import (load_optimizer_state, lr_at, make_optimizer,
                                          set_learning_rate)
from ssg_tpu_torch.train.ssg_loop import SSGConfig, join_rule, run_ssg
from ssg_tpu_torch.train.trainer import Trainer, make_train_step
from ssg_tpu_torch.utils import copy_state_dict, load_checkpoint, profiling, save_checkpoint

H, W = 64, 32


# ---- train transform -------------------------------------------------------

def _jax_crop_flip(images, boxes, flips, height, width):
    """JAX's RandomSizedRectCrop + flip on given boxes: the scale and
    translation that ``ssg_tpu.data.transforms._crop_one`` builds from its
    draws, then ``jax.image.scale_and_translate``."""
    out = []
    for img, (y0, x0, ch, cw), flip in zip(images, boxes.astype(np.float32), flips):
        y0, x0, ch, cw = map(jnp.float32, (y0, x0, ch, cw))
        scale = jnp.stack([height / ch, width / cw])
        translation = jnp.stack([-y0 * height / ch, -x0 * width / cw])
        r = jax.image.scale_and_translate(jnp.asarray(img, jnp.float32), (height, width, 3),
                                          (0, 1), scale, translation, method="bilinear")
        out.append(r[:, ::-1] if flip else r)
    return np.asarray(jnp.stack(out))


def _boxes(rng, n, h, w):
    """Boxes as the draw makes them, and some at the clip limits."""
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    boxes, _ = transforms.draw_crops(g, n, h, w)
    boxes = boxes.numpy()
    boxes[0] = (0.0, 0.0, h, w)  # the whole image
    boxes[1, 2:] = (1.0, 1.0)  # the smallest crop
    return boxes, rng.random(n) < 0.5


# Output size equal to the raw size (the loop's case), larger than it, and
# smaller (where JAX widens the kernel: antialiasing).
@pytest.mark.parametrize("src,dst", [((64, 32), (64, 32)), ((40, 24), (64, 32)),
                                     ((128, 64), (64, 32))])
def test_crop_flip_matches_scale_and_translate(rng, src, dst):
    images = rng.integers(0, 256, size=(6, *src, 3), dtype=np.uint8)
    boxes, flips = _boxes(rng, 6, *src)
    ours = transforms.crop_flip(torch.from_numpy(images), torch.from_numpy(boxes),
                                torch.from_numpy(flips), *dst).numpy()
    ref = _jax_crop_flip(images, boxes, flips, *dst)
    assert ours.shape == ref.shape == (6, *dst, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)  # 0..255 scale


def test_draw_crops_distribution():
    g = torch.Generator().manual_seed(0)
    boxes, flips = transforms.draw_crops(g, 4096, 256, 128)
    y0, x0, ch, cw = boxes.double().unbind(1)
    assert abs(float(flips.float().mean()) - 0.5) <= 0.03
    assert bool(((ch >= 1) & (ch <= 256) & (cw >= 1) & (cw <= 128)).all())
    assert bool(((y0 >= 0) & (y0 + ch <= 256 + 1e-3) & (x0 >= 0) & (x0 + cw <= 128 + 1e-3)).all())
    # Boxes that no side clipped keep the drawn area and aspect.
    free = (ch < 256) & (cw < 128)
    assert int(free.sum()) > 1000
    area = (ch * cw / (256 * 128))[free]
    aspect = (ch / cw)[free]
    assert float(area.min()) >= 0.64 - 1e-4 and float(area.max()) <= 1.0 + 1e-4
    assert float(aspect.min()) >= 2.0 - 1e-4 and float(aspect.max()) <= 3.0 + 1e-4
    # The corner spreads over the whole slack.
    slack = (y0 / (256 - ch).clamp_min(1e-6))[ch < 255]
    assert float(slack.min()) < 0.05 and float(slack.max()) > 0.95


# ---- sampler, prefetch, semi ------------------------------------------------

def test_sampler_prefetch_and_semi_match_jax():
    ds = datasets.create("market1501", scale="tiny", seed=1)
    for k, seed in [(4, 0), (2, 5), (9, 3)]:  # 9 > images per id: with replacement
        ours = RandomIdentitySampler(ds.train, num_instances=k, seed=seed)
        ref = JaxSampler(ds.train, num_instances=k, seed=seed)
        assert len(ours) == len(ref)
        for epoch_seed in (None, 11):
            a = list(ours.batches(16, seed=epoch_seed))
            b = list(ref.batches(16, seed=epoch_seed))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    items = [np.full(3, i) for i in range(7)]
    for x, y in zip(prefetch(iter(items), depth=2), jax_prefetch(iter(items), depth=2)):
        np.testing.assert_array_equal(x, y)

    def boom():
        yield 1
        raise KeyError("producer")

    with pytest.raises(KeyError):
        list(prefetch(boom()))
    one_shot = semi.one_shot_subset(ds.train, seed=3)
    assert one_shot == jax_semi.one_shot_subset(ds.train, seed=3)
    labels = np.random.default_rng(0).integers(-1, 6, len(ds.train)).astype(np.int32)
    np.testing.assert_array_equal(semi.affiliate_clusters(labels, one_shot),
                                  jax_semi.affiliate_clusters(labels, one_shot))


def test_join_rule_matches_jax():
    labels = np.array([[0, -1, 2, 2, 5, 7], [1, 1, -1, 0, 0, 3], [-1, 0, 0, 0, 1, -1]],
                      dtype=np.int32)
    for a, b in zip(join_rule(labels), jax_join_rule(labels)):
        np.testing.assert_array_equal(a, b)


# ---- triplet -----------------------------------------------------------------

# P x K labels, noise rows (-1), an anchor whose only positive is itself,
# and duplicated embeddings (ties at the clamped diagonal and among maxima).
@pytest.mark.parametrize("labels,dup", [
    ([0, 0, 0, 0, 1, 1, 1, 1], False),
    ([0, 0, -1, 1, 1, 2, -1, 3, 3, 3], False),
    ([0, 0, 1, 1, 2, -1, -1, 0], True),
    ([-1, -1, 0, 1], False),
])
def test_triplet_matches_jax(rng, labels, dup):
    x = rng.normal(size=(len(labels), 24)).astype(np.float32)
    if dup:
        x[1] = x[0]
        x[3] = x[2]
    lab = np.asarray(labels, np.int32)

    def jloss(e):
        return jax_triplet(e, jnp.asarray(lab), 0.3)

    jl, jp = jloss(jnp.asarray(x))
    jg = np.asarray(jax.grad(lambda e: jloss(e)[0])(jnp.asarray(x)))

    e = torch.from_numpy(x).requires_grad_()
    loss, prec = TripletLoss(0.3)(e, torch.from_numpy(lab).long())
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-6, abs=1e-7)
    assert float(prec) == pytest.approx(float(jp), rel=1e-6, abs=1e-7)
    scale = max(float(np.abs(jg).max()), 1e-12)
    np.testing.assert_allclose(e.grad.numpy(), jg, rtol=0, atol=1e-6 * scale)


# ---- train-mode forward, gradients, AdamW -----------------------------------

def _jax_pair(rng, num_features=16, num_classes=0, batch=16):
    kw = dict(stage_sizes=(1, 1), num_features=num_features, num_classes=num_classes,
              num_parts=3)
    fm = jax_models.SSGResNet(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, **kw)
    x = rng.normal(size=(batch, H, W, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    # Non-trivial statistics and affine terms, so their updates count.
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "scale" else a), v["params"])
    variables = {"params": params, "batch_stats": stats}
    tm = models.create("resnet50", **kw)
    tm.load_state_dict(from_jax_variables(variables))
    return fm, variables, tm


def _two_pass_variance():
    """Flax's BatchNorm with the batch variance as E[(x - E[x])^2], as
    PyTorch takes it, in place of its default E[x^2] - E[x]^2 in fp32, whose
    cancellation moves JAX's train-mode embeddings further from the same
    forward in fp64 than the port's (held below: the port within 1e-5, JAX
    as it stands within 1e-4). The reference keeps every other step of
    JAX's computation."""
    orig = flax_normalization._compute_stats
    return mock.patch.object(flax_normalization, "_compute_stats",
                             lambda *a, **k: orig(*a, **{**k, "use_fast_variance": False}))


def test_train_forward_and_bn_statistics_match_jax(rng):
    fm, variables, tm = _jax_pair(rng, num_features=16, batch=16)
    x = rng.normal(size=(16, H, W, 3)).astype(np.float32)
    exact = copy.deepcopy(tm).double()
    exact.dtype = torch.float64
    with torch.no_grad(), mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        want = exact.train()(torch.from_numpy(x).double())["embeddings"].numpy()
    bns = {name: m for name, m in tm.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    before = {name: (m.running_mean.clone(), m.running_var.clone()) for name, m in bns.items()}
    inputs = {}
    for name, m in bns.items():
        m.register_forward_pre_hook(lambda mod, args, name=name: inputs.__setitem__(name, args[0]))
    with _two_pass_variance():
        out, upd = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    fast, _ = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ours = tm.train()(torch.from_numpy(x))["embeddings"].detach().numpy()
    # Within 1e-5 of the same forward in fp64; JAX's fp32 forward (two-pass
    # variance) may be as far from it on its side, so the two within 2e-5.
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(out["embeddings"]), rtol=0, atol=2e-5)
    # JAX as it stands (fast variance): within its own error.
    np.testing.assert_allclose(ours, np.asarray(fast["embeddings"]), rtol=0, atol=1e-4)
    # Running statistics after one forward, every BN of the model, within
    # 1e-6: the momentum-0.1 update with the biased batch variance, against
    # JAX and against each BN's input in fp64. The feature BNs see 16 rows,
    # where the unbiased variance would be 6.7 % larger.
    ref = from_jax_variables({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    for name, m in bns.items():
        a = inputs[name].detach().double()
        dims = [d for d in range(a.dim()) if d != 1]
        mean, var = a.mean(dims), a.var(dims, unbiased=False)
        rm0, rv0 = (t.double() for t in before[name])
        for stat, got, expect in (("running_mean", m.running_mean, 0.9 * rm0 + 0.1 * mean),
                                  ("running_var", m.running_var, 0.9 * rv0 + 0.1 * var)):
            # 1e-6 of each tensor's largest entry too: 0.9 r + 0.1 mean can
            # cancel to nearly 0.
            atol = 1e-6 * float(expect.abs().max())
            np.testing.assert_allclose(got.double().numpy(), expect.numpy(), rtol=1e-6,
                                       atol=atol, err_msg=f"{name}.{stat}")
            np.testing.assert_allclose(got.numpy(), ref[f"{name}.{stat}"].numpy(), rtol=1e-6,
                                       atol=atol, err_msg=f"{name}.{stat} against JAX")


def _jax_value_and_grad(fm, num_parts, ce_weight):
    """JAX's SSG loss (``ssg_tpu.train.trainer.make_train_step``'s
    ``loss_fn``) on an augmented batch: ``f(params, batch_stats, x, labels)
    -> ((loss, new batch_stats), grads)``, jitted."""
    def loss_fn(params, batch_stats, x, labels):
        out, upd = fm.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                            mutable=["batch_stats"])
        emb = out["embeddings"]
        total = 0.0
        for g in range(num_parts):
            total = total + jax_triplet(emb[g], labels[g], 0.3)[0]
        if ce_weight > 0.0:
            ids = labels[num_parts]
            mask = ids >= 0
            for g in range(num_parts):
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    out["logits"][g], jnp.maximum(ids, 0))
                total = total + ce_weight * jnp.sum(jnp.where(mask, ce, 0.0)) / jnp.maximum(
                    jnp.sum(mask), 1)
        return total, upd["batch_stats"]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# The plain SSG step, and the SSG++ step (classifier heads, cross-entropy on
# an identity row with unknown (-1) entries).
@pytest.mark.parametrize("num_classes,ce_weight", [(0, 0.0), (5, 0.5)])
def test_train_step_matches_jax(rng, num_classes, ce_weight):
    lr = 1e-3
    fm, variables, tm = _jax_pair(rng, num_features=16, num_classes=num_classes, batch=8)
    images = rng.integers(0, 256, size=(8, H, W, 3), dtype=np.uint8)
    labels = np.stack([np.repeat(np.arange(2), 4), [0, 0, -1, 1, 1, 1, -1, 0],
                       [0, 1, 0, 1, 0, 1, 0, 1]]).astype(np.int32)
    if num_classes:
        labels = np.concatenate([labels, [[3, -1, 3, 1, 1, -1, 4, 4]]]).astype(np.int32)
    optimizer = make_optimizer(tm.parameters(), lr)
    step = make_train_step(tm, optimizer, num_parts=3, ce_weight=ce_weight, height=H, width=W)
    tx = jax_make_optimizer(lr, weight_decay=5e-4)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    value_and_grad = _jax_value_and_grad(fm, 3, ce_weight)
    for i in range(2):
        boxes, flips = _boxes(rng, 8, H, W)
        x = _jax_crop_flip(images, boxes, flips, H, W) / 255.0
        x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        with _two_pass_variance():
            (jl, new_stats), grads = value_and_grad(params, stats, jnp.asarray(x, jnp.float32),
                                                    jnp.asarray(labels))
        metrics = step(torch.from_numpy(images), torch.from_numpy(labels).long(),
                       crops=(torch.from_numpy(boxes), torch.from_numpy(flips)))
        assert float(metrics["loss"]) == pytest.approx(float(jl), rel=1e-5)
        if i == 0:
            # Gradients, tensor by tensor: AdamW's first step is about
            # lr * sign(g) and would hide their scale.
            # The triplet loss does not move when every embedding shifts
            # alike, so the feature heads' bias gradients are 0 up to fp32
            # noise: their scale is floored at 1e-3 of the largest gradient.
            ref = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
            named = dict(tm.named_parameters())
            assert set(ref) == set(named)
            floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
            for key, g in ref.items():
                scale = max(float(g.abs().max()), floor)
                np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=0,
                                           atol=1e-4 * scale, err_msg=key)
        updates, opt_state = tx.update(grads, opt_state, params)
        params, stats = optax.apply_updates(params, updates), new_stats
    # Parameters after two AdamW steps. An Adam step divides each gradient
    # entry by its own running size, so an entry's fp32 error relative to
    # itself reaches the parameter as that share of lr: the gradients agree
    # within 1e-4 of each tensor's largest (above), entries a thousand
    # times smaller to ~1e-2 of themselves. So: within 1e-2 lr on 99.9 % of
    # entries. An Adam step moves a parameter by at most about lr, so two
    # steps on gradients that are fp32 noise (the feature heads' biases
    # above), each taking the other sign, differ by up to 4 lr: the bound
    # everywhere.
    ref = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    state = tm.state_dict()
    diffs = np.concatenate([np.abs(state[k].numpy() - v.numpy()).ravel() for k, v in ref.items()])
    assert diffs.max() <= 4 * lr
    assert (diffs <= 1e-2 * lr).mean() >= 0.999


def test_adamw_matches_optax(rng):
    lr, wd = 6e-5, 5e-4
    p0 = rng.normal(size=(300,)).astype(np.float32)
    p = torch.from_numpy(p0.copy()).requires_grad_()
    opt = make_optimizer([p], lr, weight_decay=wd)
    tx = jax_make_optimizer(lr, weight_decay=wd)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for i in range(6):
        g = rng.normal(size=(300,)).astype(np.float32) * (i + 1)
        if i == 3:  # a new learning rate, as lr_at gives one per epoch
            set_learning_rate(opt, 2 * lr)
            state.hyperparams["learning_rate"] = jnp.asarray(2 * lr, jnp.float32)
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        # 1e-3 of lr, plus 2 ulps of the parameter a step so far: each side
        # rounds p twice a step (the decay and the update) in its own order.
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2.5e-7 * (i + 1),
                                   atol=1e-3 * lr)
    for args in [(0, 1e-3), (45, 1e-3, "step", 40, 0.1), (1, 1e-3, "constant", 40, 0.1, 4)]:
        assert lr_at(*args) == jax_lr_at(*args)


def test_train_step_reduces_loss_plain_remat_and_oim(rng):
    base = (rng.random((4, 32, 16, 3)) * 255).astype(np.uint8)
    images = torch.from_numpy(np.repeat(base, 4, axis=0))
    labels = torch.from_numpy(np.tile(np.repeat(np.arange(4), 4)[None], (4, 1)))
    for kw in ({}, {"remat": True}, {"oim_weight": 1.0, "lut": torch.zeros(6, 32)}):
        tm = models.create("resnet50", stage_sizes=(1, 1), num_features=32)
        tm.reset_parameters(torch.Generator().manual_seed(0))
        step = make_train_step(tm, make_optimizer(tm.parameters(), 1e-3), num_parts=3,
                               height=32, width=16, **kw)
        g = torch.Generator().manual_seed(1)
        losses = [float(step(images, labels, g)["loss"]) for _ in range(8)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], kw
    # The OIM table moved its four classes to unit rows and left the rest.
    norms = kw["lut"].norm(dim=1)
    np.testing.assert_allclose(norms[:4].numpy(), 1.0, rtol=1e-6)
    assert not bool(kw["lut"][4:].any())
    with pytest.raises(ValueError, match="lut"):
        make_train_step(tm, make_optimizer(tm.parameters(), 1e-3), oim_weight=0.1)


def _cpu_steps(rng, steps=3, **kw):
    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    step = make_train_step(tm, make_optimizer(tm.parameters(), 1e-3), num_parts=3, height=32,
                           width=16, **kw)
    images = torch.from_numpy(rng.integers(0, 256, size=(8, 32, 16, 3), dtype=np.uint8))
    labels = torch.from_numpy(np.tile(np.repeat(np.arange(2), 4)[None], (3, 1)))
    g = torch.Generator().manual_seed(0)
    with profiling.record_spans():
        losses = [float(step(images, labels, g)["loss"]) for _ in range(steps)]
    return losses, profiling.recorded().counters


def test_train_step_never_captures_on_the_cpu(rng, monkeypatch):
    # The CUDA graphs engage only where the parameters are on the card.
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    losses, _ = _cpu_steps(rng, steps=4)
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("kw", [{}, {"ce_weight": 0.5}, {"remat": True}])
def test_train_step_counts_no_graph_replays_on_the_cpu(rng, kw):
    _, counters = _cpu_steps(rng, **kw)
    assert counters.get("train.graph_replays", 0) == 0


def test_make_optimizer_is_capturable_only_on_the_card():
    p = torch.zeros(3, requires_grad=True)
    assert make_optimizer([p], 1e-3).param_groups[0]["capturable"] is False
    groups = [{"params": [p]}, {"params": [torch.zeros(2, requires_grad=True)]}]
    opt = make_optimizer(groups, 1e-3)
    assert [g["capturable"] for g in opt.param_groups] == [False, False]
    assert opt.param_groups[0]["foreach"] is True
    if torch.cuda.is_available():  # a card's parameters, all of them
        q = torch.zeros(3, device="cuda", requires_grad=True)
        assert make_optimizer([q], 1e-3).param_groups[0]["capturable"] is True
        assert make_optimizer([p, q], 1e-3).param_groups[0]["capturable"] is False


def test_load_optimizer_state_keeps_this_devices_capturable():
    # A checkpoint written on the card (capturable, its step counters there)
    # resumes on the CPU as the CPU's optimizer: not capturable, counters on
    # the host, and the next step continues the count.
    p = torch.zeros(3, requires_grad=True)
    opt = make_optimizer([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    saved = opt.state_dict()
    saved["param_groups"][0]["capturable"] = True
    resumed = make_optimizer([p], 1e-3)
    load_optimizer_state(resumed, saved)
    assert resumed.param_groups[0]["capturable"] is False
    resumed.step()
    assert float(resumed.state[p]["step"]) == 2.0 and resumed.state[p]["step"].device.type == "cpu"


def test_fused_eval_fold_cache_refolds_after_step(rng):
    fused = models.create("resnet50", stage_sizes=(2, 2), num_features=0, fused_eval=True)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    plain = models.create("resnet50", stage_sizes=(2, 2), num_features=0)
    blk = fused.backbone.layer1[1]
    x = torch.from_numpy(rng.normal(size=(2, H, W, 3)).astype(np.float32))
    optimizer = make_optimizer(fused.parameters(), 1e-2)
    step = make_train_step(fused, optimizer, num_parts=3, height=H, width=W)
    images = torch.from_numpy(rng.integers(0, 256, size=(8, H, W, 3), dtype=np.uint8))
    labels = torch.from_numpy(np.tile(np.repeat(np.arange(2), 4)[None], (3, 1)))
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        with torch.no_grad():
            first = blk.folded(torch.float32)
            fused.eval()(x)
        step(images, labels, g)  # AdamW moves the masters, BN the statistics
        assert blk.folded(torch.float32) is not first
        plain.load_state_dict(fused.state_dict())
        with torch.no_grad():
            torch.testing.assert_close(fused.eval()(x)["embeddings"],
                                       plain.eval()(x)["embeddings"], rtol=0, atol=1e-5)


def test_checkpoint_roundtrip_and_copy_state_dict(tmp_path, rng):
    state = {"model": {"w": torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32))},
             "iteration": 3}
    save_checkpoint(state, is_best=True, fpath=str(tmp_path / "checkpoint.pth"))
    back = load_checkpoint(str(tmp_path / "checkpoint.pth"), device="cpu")
    assert torch.equal(back["model"]["w"], state["model"]["w"]) and back["iteration"] == 3
    assert load_checkpoint(str(tmp_path / "model_best.pth"))["iteration"] == 3
    save_checkpoint({"iteration": 4}, is_best=False, fpath=str(tmp_path / "checkpoint.pth"))
    assert load_checkpoint(str(tmp_path / "model_best.pth"))["iteration"] == 3
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope.pth"))

    dst = {"backbone.w": torch.zeros(4, 4), "classifier_whole.weight": torch.zeros(10, 4)}
    src = {"module.backbone.w": torch.ones(4, 4),
           "module.classifier_whole.weight": torch.ones(7, 4),  # another id count
           "module.extra": torch.ones(2)}
    out = copy_state_dict(src, dst, strip="module.")
    assert torch.equal(out["backbone.w"], torch.ones(4, 4))
    assert torch.equal(out["classifier_whole.weight"], torch.zeros(10, 4))
    assert "extra" not in out
    with pytest.raises(KeyError):
        copy_state_dict({"classifier_whole.weight": torch.ones(7, 4)},
                        {"classifier_whole.weight": torch.zeros(10, 4)})


# ---- the SSG loop -------------------------------------------------------------

def _tiny_target(factory):
    tgt = factory("market1501", scale="tiny", seed=2)
    render = tgt.render
    tgt.render = lambda fnames: render(fnames)[:, ::4, ::4, :]
    return tgt


_LOOP = dict(batch_size=16, num_instances=2, k1=8, k2=3, rho=0.02, min_samples=2,
             height=H, width=W, print_freq=1)


def test_run_ssg_iteration0_matches_jax_and_resumes(tmp_path):
    fm = jax_models.SSGResNet(stage_sizes=(1, 1), num_features=16, dtype=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    variables = fm.init(jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)), train=False)
    # JAX's loop with no epochs: iteration 0's extract, clustering and
    # evaluation, without compiling its train step.
    _, jhist = jax_run_ssg(fm, variables, _tiny_target(jax_datasets.create),
                           JaxConfig(iterations=1, epochs=0, logs_dir=str(tmp_path / "jax"),
                                     **_LOOP))

    tm = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    tgt = _tiny_target(datasets.create)
    logs = tmp_path / "torch"
    cfg = SSGConfig(iterations=1, epochs=1, logs_dir=str(logs), **_LOOP)
    opt, hist = api.train(tm, tgt, cfg, device="cpu")
    assert [h["iteration"] for h in hist] == [0]
    (ours,), (ref,) = hist, jhist
    assert [c for c, _ in ours["clusters"]] == [c for c, _ in ref["clusters"]]
    # The two extracts differ by fp32 sums in another order. The
    # random-weight features are near duplicates, so eps (~1e-3) is a
    # cancellation residue that moves by more than 1e-6 with them; on the
    # same features the port's eps is within 1e-6 of JAX's
    # (test_torch_pipeline).
    np.testing.assert_allclose([e for _, e in ours["clusters"]],
                               [e for _, e in ref["clusters"]], rtol=0, atol=2e-6)
    assert ours["kept"] == ref["kept"]
    assert ours["steps"] > 0 and np.isfinite(ours["loss"]) and "mAP" in ours
    assert {"extract_seconds", "cluster_seconds", "train_seconds", "eval_seconds"} <= set(ours)
    assert (logs / "checkpoint.pth").exists() and (logs / "model_best.pth").exists()

    # Resume: iteration 1 starts from iteration 0's model and AdamW state
    # (no epochs, so the restored state is what the loop ends with).
    ckpt = load_checkpoint(str(logs / "checkpoint.pth"))
    resumed = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    cfg2 = SSGConfig(iterations=2, epochs=0, logs_dir=str(logs), **_LOOP)
    opt2, hist2 = run_ssg(resumed, tgt, cfg2, resume_from=str(logs / "checkpoint.pth"),
                          device="cpu")
    assert [h["iteration"] for h in hist2] == [1]
    saved = ckpt["optimizer"]["state"]
    restored = opt2.state_dict()["state"]
    assert set(saved) == set(restored)
    for i in saved:
        assert torch.equal(restored[i]["exp_avg"], saved[i]["exp_avg"])
        assert torch.equal(restored[i]["exp_avg_sq"], saved[i]["exp_avg_sq"])
        assert float(restored[i]["step"]) == float(saved[i]["step"]) == ours["steps"]
    for key, value in ckpt["model"].items():
        assert torch.equal(resumed.state_dict()[key], value), key
    # data_parallel: the batch must divide over the mesh's ranks, as JAX
    # requires (checked before any work; the loop over ranks is held to JAX
    # in tests/test_torch_dp.py).
    three = Mesh(None, 0, 3, torch.device("cpu"), "gloo")
    with mock.patch("ssg_tpu_torch.train.ssg_loop.make_mesh", return_value=three), \
            pytest.raises(ValueError, match="divisible"):
        run_ssg(resumed, tgt, SSGConfig(data_parallel=True, **_LOOP), device="cpu")
