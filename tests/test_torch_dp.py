"""Port parity of the data-parallel layer over ranks (CPU, gloo).

P = 2 and 4 gloo processes (``tests/torch_dist_ranks.py``, one spawn a P)
take SGD train steps of a shallow model (``stage_sizes=(1, 1)``, 64x32,
fp32) with ``make_train_step(..., mesh=)``, extract features over the mesh
and evaluate with the mesh ``Evaluator``; this process runs the same
calls on a mesh of one, and JAX's step on ``make_mesh(P)`` (the loss on
the whole batch, sharded over the mesh: JAX's DP step, with Flax's
two-pass variance as ``tests/test_torch_train.py`` holds it). SGD keeps
an update linear in the gradient, as ``tests/test_dp_training.py`` does.

The contract is JAX's: the DP step equals the one-device step on the
whole batch. Per-rank semantics would break it in four places, one test
each: (a) BatchNorm statistics over the global batch, (b) the batch-hard
triplet searched over the global batch, (c) SSG++'s cross-entropy over
the global count of labelled rows, (d) crops and flips drawn for the
global batch. Tolerances: losses within 1e-5 relative; parameters and BN
statistics within 1e-5 relative (1e-6 absolute); against JAX's DP step
the first update no further than twice the port's one-device update is
from JAX's one-device update (the split adds no error); embeddings over the mesh
equal to one process's; the mesh evaluator's mAP within 1e-6 and its CMC
equal; ``selftraining --data_parallel`` over two ranks (``--multihost
--dist_*``) gives the labels of one rank, and JAX's streaming labels on
``make_mesh(2)`` for the same features (where JAX's own labels do not
move with its mesh size).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from ssg_tpu.parallel import make_mesh as jax_make_mesh
from ssg_tpu.parallel import streaming as jax_streaming

from ssg_tpu_torch.models.convert import from_jax_variables
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss

import torch_dist_ranks
from test_torch_train import (H, W, _boxes, _jax_crop_flip, _jax_pair, _jax_value_and_grad,
                              _two_pass_variance)
from ssg_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD

LR = 1e-3
B = 8
# test_torch_train's labels: the whole-body row holds one identity a half,
# so at P = 2 and 4 no anchor has a negative on its own rank, and a
# per-rank search finds no anchor there (trap b).
LABELS = np.stack([np.repeat(np.arange(2), 4), [0, 0, -1, 1, 1, 1, -1, 0],
                   [0, 1, 0, 1, 0, 1, 0, 1]]).astype(np.int32)
# SSG++'s identity row: one labelled row in the first half, three in the
# second, so a per-rank count divides differently (trap c).
ID_ROW = np.array([[3, -1, -1, -1, 1, 1, -1, 4]], np.int32)


def _payload(rng):
    fm, variables, tm = _jax_pair(rng, num_features=16, batch=B)
    fm5, variables5, tm5 = _jax_pair(rng, num_features=16, num_classes=5, batch=B)
    images = [rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8) for _ in range(2)]
    crops = [_boxes(rng, B, H, W) for _ in range(2)]
    semi_labels = np.concatenate([LABELS, ID_ROW]).astype(np.int32)
    batches = [(rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8), np.zeros(B),
                np.zeros(B), np.arange(B) < (B if i == 0 else 5)) for i in range(2)]
    scenarios = {
        "plain": {"steps": [(im, LABELS, c) for im, c in zip(images, crops)]},
        "semi": {"steps": [(im, semi_labels, c) for im, c in zip(images, crops)],
                 "ce_weight": 0.5, "model_kw": {"num_classes": 5},
                 "state": tm5.state_dict()},
        "drawn": {"steps": [(im, LABELS, None) for im in images], "seed": 5},
        "remat": {"steps": [(im, LABELS, c) for im, c in zip(images, crops)], "remat": True},
    }
    payload = {"model_kw": dict(stage_sizes=(1, 1), num_features=16, num_parts=3),
               "state": tm.state_dict(), "lr": LR, "h": H, "w": W, "scenarios": scenarios,
               "batches": batches, "eval_batch": 6}
    return payload, (fm, variables), (fm5, variables5)


def _jax_dp_steps(p, fm, variables, steps, ce_weight):
    """JAX's DP step on make_mesh(p): the whole-batch loss with the batch
    sharded over the mesh and the parameters replicated, then SGD. Returns
    the losses and the parameters after the first step."""
    mesh = jax_make_mesh(p)
    shard = NamedSharding(mesh, PartitionSpec("data"))
    rep = NamedSharding(mesh, PartitionSpec())
    params = jax.device_put(variables["params"], rep)
    stats = jax.device_put(variables["batch_stats"], rep)
    value_and_grad = _jax_value_and_grad(fm, 3, ce_weight)
    losses, first = [], None
    for images, labels, (boxes, flips) in steps:
        x = _jax_crop_flip(images, boxes, flips, H, W) / 255.0
        x = ((x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)
        with _two_pass_variance():
            (loss, stats), grads = value_and_grad(params, stats, jax.device_put(x, shard),
                                                  jax.device_put(jnp.asarray(labels), rep))
        params = jax.tree.map(lambda q, g: q - LR * g, params, grads)
        losses.append(float(loss))
        if first is None:
            first = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    return losses, first


@pytest.fixture(scope="module")
def single():
    """The payload, the mesh-of-one results and JAX's pair of models."""
    rng = np.random.default_rng(0)
    payload, jax_plain, jax_semi = _payload(rng)
    one = torch_dist_ranks.dp_scenarios(torch_dist_ranks.one_rank_mesh(), payload)
    fm, variables = jax_plain
    _, first = _jax_dp_steps(1, fm, variables, payload["scenarios"]["plain"]["steps"][:1], 0.0)
    return {"payload": payload, "one": one, "jax_plain": jax_plain, "jax_semi": jax_semi,
            "jax_one_device_error": _update_error(first, one["plain"]["first"],
                                                  payload["state"])}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, single):
    p = request.param
    return {"p": p, "results": torch_dist_ranks.run_ranks(torch_dist_ranks.dp_scenarios, p,
                                                          single["payload"])}


def _assert_state(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for key, ref in want.items():
        ref = ref.detach().double()
        np.testing.assert_allclose(got[key].detach().double().numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{what}: {key}")


def _assert_scenario(ranks, single, name):
    want = single["one"][name]
    for r in ranks["results"]:
        got = r[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _assert_state(got["params"], want["params"], f"{name} P{ranks['p']}")
        _assert_state(got["bn"], want["bn"], f"{name} P{ranks['p']} BN")


def test_dp_step_matches_one_device_and_jax_mesh(ranks, single):
    _assert_scenario(ranks, single, "plain")
    fm, variables = single["jax_plain"]
    losses, first = _jax_dp_steps(ranks["p"], fm, variables,
                                  single["payload"]["scenarios"]["plain"]["steps"], 0.0)
    # Against JAX: both losses within 1e-5. The first step's update: an
    # SGD update is -lr g, and the port's gradients differ from JAX's by the
    # fp32 rounding of the whole network at random initialisation (one
    # device against one device, ~1e-4 of a tensor's largest, more on some
    # inputs). The split must add nothing to that: the worst error of the
    # port's DP update against JAX's DP update, each tensor's in units of
    # its largest update (floored at 1e-3 of the largest of all, the feature
    # heads' bias gradients being fp32 noise about 0), is at most twice the
    # port's one-device update's against JAX's one-device update.
    worst = _update_error(first, single["one"]["plain"]["first"], single["payload"]["state"])
    for r in ranks["results"]:
        np.testing.assert_allclose(r["plain"]["losses"], losses, rtol=1e-5)
        got = _update_error(first, r["plain"]["first"], single["payload"]["state"])
        assert got <= 2.0 * single["jax_one_device_error"], (got, worst)


def _update_error(ref: dict, got: dict, p0: dict) -> float:
    """Worst |got - ref| of the updates from ``p0``, each tensor's in units
    of its largest reference update (floored at 1e-3 of the largest of all)."""
    delta = {k: (ref[k] - p0[k]).double() for k in got}
    floor = 1e-3 * max(float(d.abs().max()) for d in delta.values())
    return max(float(((got[k] - p0[k]).double() - d).abs().max()) / max(float(d.abs().max()),
                                                                         floor)
               for k, d in delta.items())


def test_dp_batchnorm_statistics_are_the_global_batch(ranks, single):
    """(a): every BatchNorm's running statistics after two DP steps are the
    one-device step's on the whole batch (and so is everything they feed)."""
    want = single["one"]["plain"]["bn"]
    for r in ranks["results"]:
        _assert_state(r["plain"]["bn"], want, f"BN P{ranks['p']}")


def test_dp_triplet_searches_the_global_batch(ranks, single):
    """(b): the loss is the batch-hard triplet over the global batch. On
    these labels no whole-body anchor has a negative on its own rank, so a
    per-rank search would give a different loss."""
    emb = torch.randn(3, B, 16, generator=torch.Generator().manual_seed(0))
    labels = torch.from_numpy(LABELS).long()
    whole = sum(batch_hard_triplet_loss(emb[g], labels[g])[0] for g in range(3))
    r = B // ranks["p"]
    local = sum(batch_hard_triplet_loss(emb[g, :r], labels[g, :r])[0] for g in range(3))
    assert float(local) != pytest.approx(float(whole), rel=1e-3)
    for res in ranks["results"]:
        np.testing.assert_allclose(res["plain"]["losses"], single["one"]["plain"]["losses"],
                                   rtol=1e-5)


def test_dp_cross_entropy_divides_by_the_global_labelled_count(ranks, single):
    """(c): SSG++'s term sums over the global batch and divides by its
    labelled rows (four here, spread 1 / 3 over two ranks)."""
    _assert_scenario(ranks, single, "semi")


def test_dp_crops_are_drawn_for_the_global_batch(ranks, single):
    """(d): the crops and flips come from the one generator for the whole
    batch, then each rank takes its slice."""
    _assert_scenario(ranks, single, "drawn")


def test_dp_remat_step_matches_one_device(ranks, single):
    """remat under DP: the recomputation takes the global statistics again
    and updates none."""
    _assert_scenario(ranks, single, "remat")


def test_extract_features_over_ranks_equals_one_process(ranks, single):
    want = single["one"]["extract"]
    assert tuple(want.shape) == (3, B + 5, 16)
    for r in ranks["results"]:
        np.testing.assert_array_equal(r["extract"].numpy(), want.numpy())


def test_mesh_evaluator_streams_rerank_over_ranks(ranks, single):
    mAP, cmc, bs = single["one"]["evaluator"]
    assert bs == 6
    for r in ranks["results"]:
        got_map, got_cmc, got_bs = r["evaluator"]
        assert got_bs == -(-6 // ranks["p"]) * ranks["p"]
        assert got_map == pytest.approx(mAP, abs=1e-6)
        np.testing.assert_array_equal(got_cmc, cmc)


# ---- the SSG loop through the CLI over two ranks ---------------------------------

CLI_ARGV = ["--scale", "tiny", "--batch_size", "16", "--num_instances", "2", "--arch",
            "resnet18", "--num_features", "16", "--height", "64", "--width", "32", "--dtype",
            "float32", "--device", "cpu", "--tgt_dataset", "dukemtmc", "--iteration", "1",
            "--epochs", "1", "--rho", "0.03", "--min_samples", "2", "--k1", "8", "--k2", "3",
            "--print_freq", "1"]


def test_selftraining_data_parallel_over_two_ranks(tmp_path):
    """``--data_parallel --multihost --dist_*`` on two ranks: both exit 0,
    with the labels of the one-rank run and of JAX's streaming on
    make_mesh(2) for the same features."""
    payload = {"argv": CLI_ARGV, "logs": str(tmp_path), "nprocs": 2}
    stdout = sys.stdout
    one = torch_dist_ranks.cli_ssg(0, None, {**payload, "logs": str(tmp_path / "one")})
    sys.stdout = stdout
    two = torch_dist_ranks.run_unjoined(torch_dist_ranks.cli_ssg, 2, payload)
    assert one["rc"] == 0 and [r["rc"] for r in two] == [0, 0]
    (feats, labels, counts, epss), = one["clusterings"]
    # JAX's labels on these features depend on its mesh size in a group
    # where fp32 distances nearly tie (ROADMAP C: group 0 of this run has
    # 21 clusters on make_mesh(1) and (2), 22 on make_mesh(8) and in the
    # port's dense chain): a group is held to make_mesh(2) exactly where
    # JAX's meshes agree, else to one of them.
    x = jnp.asarray(feats.numpy())
    jax_runs = [jax_streaming.streaming_cluster_groups(x, jax_make_mesh(p), k1=8, k2=3,
                                                       rho=0.03, min_samples=2)
                for p in (2, 8)]
    jax_labels = [np.asarray(run[0]) for run in jax_runs]
    for r in two:
        (f2, l2, c2, e2), = r["clusterings"]
        np.testing.assert_allclose(f2.numpy(), feats.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(l2, labels)
        assert c2 == counts
        np.testing.assert_allclose(e2, epss, rtol=1e-5)
        for g in range(l2.shape[0]):
            refs = [jl[g] for jl in jax_labels]
            if np.array_equal(refs[0], refs[1]):
                np.testing.assert_array_equal(l2[g], refs[0])
            else:
                assert any(np.array_equal(l2[g], ref) for ref in refs), g
    assert (tmp_path / "rank0" / "checkpoint.pth").exists()
    assert not (tmp_path / "rank1" / "checkpoint.pth").exists()
