"""Port parity of supervised pretraining: the OIM loss and its train step,
the remat step, and ``run_pretrain`` (batches, label rows, the
step-indexed learning rate, learning in both modes, the checkpoint),
against the JAX package on the same numpy inputs (CPU).

The train-step helpers are ``test_torch_train``'s: shallow models, 64x32
inputs, fp32, the same weights on both sides through
``from_jax_variables``, crops passed to both, Flax's two-pass variance."""

from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ssg_tpu.data import datasets as jax_datasets
from ssg_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ssg_tpu.loss.oim import OIMLoss as JaxOIMLoss
from ssg_tpu.loss.oim import oim_loss as jax_oim_loss
from ssg_tpu.models.resnet import BasicBlock as JaxBasicBlock
from ssg_tpu.models.resnet import SSGResNet as JaxSSGResNet
from ssg_tpu.ops.triplet import batch_hard_triplet_loss as jax_triplet
from ssg_tpu.train import pretrain as jax_pretrain
from ssg_tpu.train.schedule import make_optimizer as jax_make_optimizer

from ssg_tpu_torch import models
from ssg_tpu_torch.data import datasets, transforms
from ssg_tpu_torch.loss import OIMLoss, oim_loss
from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.train import pretrain
from ssg_tpu_torch.train.pretrain import PretrainConfig, run_pretrain
from ssg_tpu_torch.train.schedule import make_optimizer
from ssg_tpu_torch.train.trainer import make_train_step
from ssg_tpu_torch.utils import load_checkpoint
from test_torch_train import H, W, _boxes, _jax_crop_flip, _jax_pair, _two_pass_variance


def _unit_rows(rng, n, f):
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ---- the OIM loss ------------------------------------------------------------

def test_oim_loss_matches_jax(rng):
    # 10 classes: 0-3 hold prototypes, 4-9 are zero; the batch has K = 4
    # duplicates of classes 1 and 2, one sample of 5, and unlabelled rows.
    lut = np.zeros((10, 8), np.float32)
    lut[:4] = _unit_rows(rng, 4, 8)
    feats = _unit_rows(rng, 12, 8)
    labels = np.array([1, 1, 1, 1, 2, 2, 2, 2, 5, -1, -1, -1])
    loss, new_lut = oim_loss(torch.from_numpy(lut), torch.from_numpy(feats),
                             torch.from_numpy(labels), 0.1, 0.5)
    ref_loss, ref_lut = jax_oim_loss(jnp.asarray(lut), jnp.asarray(feats), jnp.asarray(labels),
                                     temperature=0.1, momentum=0.5)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    np.testing.assert_allclose(new_lut.numpy(), np.asarray(ref_lut), rtol=0, atol=1e-6)
    untouched = [0, 3, 4, 6, 7, 8, 9]
    assert np.array_equal(new_lut.numpy()[untouched], lut[untouched])
    np.testing.assert_allclose(np.linalg.norm(new_lut.numpy()[[1, 2, 5]], axis=1), 1.0, rtol=1e-6)
    # The unlabelled rows count for nothing; the batch order for nothing.
    perm = rng.permutation(12)
    loss_p, lut_p = oim_loss(torch.from_numpy(lut), torch.from_numpy(feats[perm]),
                             torch.from_numpy(labels[perm]), 0.1, 0.5)
    assert float(loss_p) == pytest.approx(float(loss), rel=1e-6)
    np.testing.assert_allclose(lut_p.numpy(), new_lut.numpy(), rtol=0, atol=1e-6)
    # The stateful wrapper over two calls, from a zero table.
    ours, ref = OIMLoss(8, 10, device="cpu"), JaxOIMLoss(8, 10)
    for _ in range(2):
        a, b = ours(torch.from_numpy(feats), torch.from_numpy(labels)), ref(feats, labels)
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    np.testing.assert_allclose(ours.lut.numpy(), np.asarray(ref.lut), rtol=0, atol=1e-6)
    # No gradient reaches the table.
    f = torch.from_numpy(feats).requires_grad_()
    oim_loss(torch.from_numpy(lut), f, torch.from_numpy(labels))[0].backward()
    assert f.grad is not None and float(f.grad.abs().max()) > 0


# ---- the OIM train step --------------------------------------------------------

def _jax_oim_value_and_grad(fm, num_parts, temperature, momentum):
    """JAX's SSG step loss with ``oim_weight=1`` (``ssg_tpu.train.trainer``'s
    ``loss_fn``): triplets, then OIM on the normalised whole-body branch.
    ``f(params, batch_stats, lut, x, labels) -> ((loss, (stats, lut)), grads)``."""
    def loss_fn(params, batch_stats, lut, x, labels):
        out, upd = fm.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                            mutable=["batch_stats"])
        emb = out["embeddings"]
        total = 0.0
        for g in range(num_parts):
            total = total + jax_triplet(emb[g], labels[g], 0.3)[0]
        w = emb[0].astype(jnp.float32)
        w = w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True), 1e-12)
        oim, new_lut = jax_oim_loss(lut, w, labels[num_parts], temperature=temperature,
                                    momentum=momentum)
        return total + oim, (upd["batch_stats"], new_lut)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_oim_train_step_matches_jax(rng):
    """The step parity of ``test_torch_train.test_train_step_matches_jax``,
    with its tolerances, plus the OIM term and its table: loss rel 1e-5; gradients within 1e-4
    of each tensor's largest (floored at 1e-3 of the largest gradient);
    parameters after two AdamW steps within 4 lr, 1e-2 lr on 99.9 %; the
    table within 2e-5, the train-mode embeddings' tolerance, with its
    untouched rows unchanged bit for bit. The feature heads' biases, whose
    exact gradient is 0, are held to fp32 noise instead (below 1e-6 of the
    largest gradient on both sides): with OIM in the loss their noise
    reaches 2e-7 of the largest gradient, above the 1e-7 that the floored
    comparison allows."""
    lr = 1e-3
    fm, variables, tm = _jax_pair(rng, num_features=16, num_classes=0, batch=8)
    images = rng.integers(0, 256, size=(8, H, W, 3), dtype=np.uint8)
    labels = np.stack([np.repeat(np.arange(2), 4), [0, 0, -1, 1, 1, 1, -1, 0],
                       [0, 1, 0, 1, 0, 1, 0, 1], [3, -1, 3, 1, 1, -1, 4, 4]]).astype(np.int32)
    lut0 = np.zeros((6, 16), np.float32)
    lut0[[0, 1, 3]] = _unit_rows(rng, 3, 16)  # classes 0, 2, 5 start (and stay) untouched
    lut = torch.from_numpy(lut0.copy())
    optimizer = make_optimizer(tm.parameters(), lr)
    step = make_train_step(tm, optimizer, num_parts=3, height=H, width=W, oim_weight=1.0,
                           lut=lut)
    tx = jax_make_optimizer(lr, weight_decay=5e-4)
    params, stats, jlut = variables["params"], variables["batch_stats"], jnp.asarray(lut0)
    opt_state = tx.init(params)
    value_and_grad = _jax_oim_value_and_grad(fm, 3, 0.1, 0.5)
    for i in range(2):
        boxes, flips = _boxes(rng, 8, H, W)
        x = _jax_crop_flip(images, boxes, flips, H, W) / 255.0
        x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        with _two_pass_variance():
            (jl, (new_stats, jlut)), grads = value_and_grad(
                params, stats, jlut, jnp.asarray(x, jnp.float32), jnp.asarray(labels))
        metrics = step(torch.from_numpy(images), torch.from_numpy(labels).long(),
                       crops=(torch.from_numpy(boxes), torch.from_numpy(flips)))
        assert float(metrics["loss"]) == pytest.approx(float(jl), rel=1e-5)
        np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), rtol=0, atol=2e-5)
        assert np.array_equal(lut.numpy()[[0, 2, 5]], lut0[[0, 2, 5]])
        if i == 0:
            ref = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
            named = dict(tm.named_parameters())
            assert set(ref) == set(named)
            largest = max(float(g.abs().max()) for g in ref.values())
            for key, g in ref.items():
                if key in ("feat_whole.bias", "feat_up.bias", "feat_down.bias"):
                    # A bias before a train-mode BatchNorm: its exact
                    # gradient is 0 (the BN subtracts the batch mean), so
                    # each side's is fp32 noise, to be held as such.
                    for side in (named[key].grad, g):
                        assert float(side.abs().max()) <= 1e-6 * largest, key
                    continue
                np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=0,
                                           atol=1e-4 * max(float(g.abs().max()), 1e-3 * largest),
                                           err_msg=key)
        updates, opt_state = tx.update(grads, opt_state, params)
        params, stats = optax.apply_updates(params, updates), new_stats
    ref = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    state = tm.state_dict()
    diffs = np.concatenate([np.abs(state[k].numpy() - v.numpy()).ravel() for k, v in ref.items()])
    assert diffs.max() <= 4 * lr
    assert (diffs <= 1e-2 * lr).mean() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(lut.numpy()[[1, 3, 4]], axis=1), 1.0, rtol=1e-6)


# ---- remat ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["resnet50", "resnet18", "inception"])
def test_remat_step_equals_plain_step(rng, arch):
    """The same step with and without remat, from the same weights, crops
    and dropout draws: the loss within 1e-6, each gradient within 1e-5 of
    its tensor's largest, the BatchNorm running statistics and counters
    equal. A recomputation that updated the statistics again would move
    them by the momentum. (The Inception checkpoints each inception block,
    the ResNets each residual block.)"""
    kw = dict(num_features=16, num_classes=4, dropout=0.3,
              **({"depth": 3, "width": 16} if arch == "inception" else {"stage_sizes": (1, 1)}))
    plain = models.create(arch, **kw).reset_parameters(torch.Generator().manual_seed(0))
    remat = models.create(arch, **kw)
    remat.load_state_dict(plain.state_dict())
    images = torch.from_numpy(rng.integers(0, 256, size=(8, H, W, 3), dtype=np.uint8))
    labels = torch.from_numpy(np.stack([np.repeat(np.arange(2), 4)] * 4))
    crops = transforms.draw_crops(torch.Generator().manual_seed(1), 8, H, W)
    losses = []
    for model, on in ((plain, False), (remat, True)):
        step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), num_parts=3,
                               ce_weight=0.5, height=H, width=W, remat=on)
        torch.manual_seed(5)  # the dropout draws
        losses.append(float(step(images, labels, crops=crops)["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        scale = max(float(p.grad.abs().max()), 1e-12)
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
    remat_state = remat.state_dict()
    for name, t in plain.state_dict().items():
        if "running" in name or "num_batches_tracked" in name:
            assert torch.equal(remat_state[name], t), name


# ---- run_pretrain --------------------------------------------------------------------

def _tiny_source(factory):
    src = factory("market1501", scale="tiny", seed=4)
    render = src.render
    src.render = lambda fnames: render(fnames)[:, ::4, ::4, :]
    return src


def _jax_feed(cfg, num_ids):
    """What JAX's ``run_pretrain`` gives its train step: the (images, labels)
    batches, by a stand-in ``Trainer`` that runs no step, and its optax
    learning-rate schedule."""
    batches, schedules = [], []
    adamw = optax.adamw

    class Feed:
        def __init__(self, *args, **kwargs):
            pass

        def train(self, epoch, state, batch_iter, rng, **kwargs):
            batches.extend(batch_iter)
            return state

    def capture(schedule, **kwargs):
        schedules.append(schedule)
        return adamw(schedule, **kwargs)

    model = JaxSSGResNet(stage_sizes=(1, 1), block=JaxBasicBlock, num_features=16,
                         num_classes=0 if cfg.loss == "oim" else num_ids, dtype=jnp.float32)
    with mock.patch.object(jax_pretrain, "Trainer", Feed), \
            mock.patch.object(jax_pretrain, "save_checkpoint"), \
            mock.patch.object(jax_pretrain.optax, "adamw", capture):
        jax_pretrain.run_pretrain(model, _tiny_source(jax_datasets.create),
                                  jax_pretrain.PretrainConfig(**vars(cfg)))
    return batches, schedules[0]


@pytest.mark.parametrize("loss", ["softmax", "oim"])
def test_run_pretrain_matches_jax_feed_and_schedule(tmp_path, loss):
    # 120 images of 15 identities: JAX's schedule counts 120 // 16 = 7
    # steps an epoch, the P x K sampler gives 15 * 4 // 16 = 3, so the
    # "epoch 1" decay comes at step 7, in sampler epoch 2 of 0..2.
    cfg = PretrainConfig(epochs=3, batch_size=16, num_instances=4, height=H, width=W,
                         print_freq=100, logs_dir=str(tmp_path), lr=1e-3,
                         lr_decay_epochs=(1, 5), loss=loss)
    src = _tiny_source(datasets.create)
    num_ids = len({p for _, p, _ in src.train})
    jax_batches, schedule = _jax_feed(cfg, num_ids)

    model = models.create("resnet18", stage_sizes=(1, 1), num_features=16,
                          num_classes=0 if loss == "oim" else num_ids)
    model.reset_parameters(torch.Generator().manual_seed(0))
    fed, step_losses = [], []
    build = pretrain.make_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(images, labels, generator, crops=None):
            fed.append((images.numpy().copy(), labels.numpy().copy()))
            return step(images, labels, generator, crops)

        return run

    class Probe:
        def metric(self, **kv):
            if kv.get("kind") == "train_step":
                step_losses.append(kv["loss"])

    with mock.patch.object(pretrain, "make_train_step", recording):
        optimizer, history, lut = run_pretrain(model, src, cfg, logger=Probe(), device="cpu")

    assert len(fed) == len(jax_batches) == 9 and [h["steps"] for h in history] == [3, 3, 3]
    for (images, labels), (j_images, j_labels) in zip(fed, jax_batches):
        np.testing.assert_array_equal(images, j_images)
        np.testing.assert_array_equal(labels, j_labels)  # 3 part rows + the identity row
        assert labels.shape == (4, 16) and (labels == labels[3]).all()
    lrs = [r for h in history for r in h["lrs"]]
    assert lrs == [float(schedule(c)) for c in range(9)]
    assert lrs[6] == float(np.float32(1e-3)) and lrs[7] < lrs[6]  # decayed at step 7

    assert np.isfinite(step_losses).all()
    assert np.mean(step_losses[-3:]) < np.mean(step_losses[:3])

    ckpt = load_checkpoint(str(tmp_path / "source_checkpoint.pth"))
    assert (tmp_path / "model_best.pth").exists() and ckpt["epoch"] == 3
    fresh = models.create("resnet18", stage_sizes=(1, 1), num_features=16,
                          num_classes=0 if loss == "oim" else num_ids)
    fresh.load_state_dict(ckpt["model"])
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    if loss == "oim":
        assert lut.shape == (num_ids, 16) and torch.equal(ckpt["lut"], lut)
        norms = lut.norm(dim=1)
        touched = norms > 0
        assert bool(touched.any())
        np.testing.assert_allclose(norms[touched].numpy(), 1.0, rtol=1e-5)
    else:
        assert lut is None and "lut" not in ckpt
