"""Gloo ranks on the CPU for the port's multi-rank tests.

``run_ranks(target, nprocs, payload)`` spawns ``nprocs`` processes (the
``spawn`` start method: a child imports only this module and the port,
never JAX), joins each to one gloo process group, calls
``target(mesh, payload)`` on every rank and returns their results in rank
order. A rank that raises, or a group that outlives ``timeout`` seconds,
fails the call; the other ranks are killed. ``target`` must be a
module-level function of a module that imports no JAX.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, port, target, payload, out_dir, threads, join):
    import torch.distributed as dist

    from ssg_tpu_torch.parallel import make_mesh

    torch.set_num_threads(threads)
    if not join:
        torch.save(target(rank, port, payload), os.path.join(out_dir, f"rank{rank}.pt"))
        return
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=nprocs, timeout=datetime.timedelta(seconds=120))
    try:
        result = target(make_mesh(device="cpu", backend="gloo"), payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(target, nprocs: int, payload=None, timeout: float = 240.0, threads: int = 1,
              join: bool = True):
    """Results of ``target(mesh, payload)`` on each of ``nprocs`` gloo ranks."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(nprocs, free_port(), target, payload, out_dir,
                                                   threads, join),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {target.__name__} outlived {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def run_unjoined(target, nprocs: int, payload=None, timeout: float = 240.0, threads: int = 1):
    """``run_ranks`` for a target that joins the process group itself (a
    CLI's ``--multihost``): it is called as ``target(rank, port, payload)``."""
    return run_ranks(target, nprocs, payload, timeout, threads, join=False)


# ---- targets: module-level, torch and the port only -------------------------------

def one_rank_mesh():
    """A mesh of one without a process group: the one-device forms."""
    from ssg_tpu_torch.parallel import make_mesh

    return make_mesh(device="cpu")


def ring_checks(mesh) -> dict:
    """Each ring primitive on this rank's stripes of seeded global arrays,
    against the same computation on the whole arrays."""
    from ssg_tpu_torch.ops.bits import pack_bits, unpack_bits
    from ssg_tpu_torch.parallel import ring

    p, me = mesh.size, mesh.rank
    g = torch.Generator().manual_seed(0)
    r = 16
    a = torch.randn(p * r, p * r, generator=g)
    b = torch.randn(p * r, 5, generator=g)
    mine = slice(me * r, (me + 1) * r)
    bits = a > 0.3
    idx = torch.randint(0, p * r, (7, 3), generator=g)
    packed = ring.stripe_transpose_packed(mesh, pack_bits(bits[mine]))
    shifted = ring.shift(mesh, torch.full((3,), float(me), dtype=torch.bfloat16))
    return {
        "stripe_transpose": torch.equal(ring.stripe_transpose(mesh, a[mine]), a.T[mine]),
        "stripe_transpose_packed": torch.equal(unpack_bits(packed, p * r), bits.T[mine]),
        "ring_pairwise": torch.allclose(
            ring.ring_pairwise(mesh, a[mine], a[mine], lambda x, y: x @ y.T), a[mine] @ a.T,
            rtol=1e-6, atol=1e-5),
        "ring_gather_sum": torch.allclose(ring.ring_gather_sum(mesh, idx, b[mine]),
                                          b[idx].sum(1), rtol=1e-6, atol=1e-6),
        "ring_contract": torch.allclose(ring.ring_contract(mesh, a[mine], b[mine]), a[mine] @ b,
                                        rtol=1e-6, atol=1e-5),
        "shift_bf16": torch.equal(shifted, torch.full((3,), float((me - 1) % p),
                                                      dtype=torch.bfloat16)),
    }


def parallel_chain(mesh, pl) -> dict:
    """The sharded dense chain, the sharded re-ranking and the streaming
    functions over ``mesh`` on the payload's seeded inputs."""
    from ssg_tpu_torch.parallel import (sharded_dbscan, sharded_pairwise_distance,
                                        sharded_re_ranking, sharded_select_eps,
                                        streaming_cluster, streaming_cluster_groups,
                                        streaming_rerank_eval)

    kw = pl["kw"]
    out = {"ring": ring_checks(mesh) if mesh.size > 1 else None}
    dist = sharded_pairwise_distance(pl["feats"], mesh)
    eps = sharded_select_eps(dist, mesh, rho=kw["rho"])
    labels, n_clusters = sharded_dbscan(dist, eps, mesh, min_samples=kw["min_samples"])
    out.update(dist=dist, eps=float(eps), labels=labels.numpy(), n_clusters=int(n_clusters))
    # DBSCAN on JAX's own matrix and eps: the labels must be equal exactly.
    jd = torch.from_numpy(pl["jax_dist"])
    r = dist.shape[0]
    stripe = torch.zeros((r, jd.shape[0]))
    rows = jd[mesh.rank * r:(mesh.rank + 1) * r]
    stripe[:rows.shape[0]] = rows
    out["labels_on_jax"] = sharded_dbscan(stripe, pl["jax_eps"], mesh,
                                          min_samples=kw["min_samples"])[0].numpy()
    out["rerank"] = sharded_re_ranking(pl["feats"], mesh, k1=kw["k1"], k2=kw["k2"],
                                       lambda_value=kw["lambda_value"])
    stream = {k: kw[k] for k in ("k1", "k2", "lambda_value", "rho", "min_samples")}
    diag = {}
    out["groups"] = streaming_cluster_groups(pl["groups"], chunk=pl["chunk"], diag=diag,
                                             mesh=mesh, **stream)
    out["groups_codes"] = diag["fallback_code"]
    diag = {}
    out["fallback"] = streaming_cluster(pl["groups"][0], chunk=pl["chunk"], band_cap=0,
                                        diag=diag, mesh=mesh, **stream)
    out["fallback_code"] = diag["fallback_code"]
    ev = pl["eval"]
    out["eval"] = streaming_rerank_eval(ev["qf"], ev["gf"], ev["q_ids"], ev["g_ids"],
                                        ev["q_cams"], ev["g_cams"], k1=kw["k1"], k2=kw["k2"],
                                        chunk=pl["chunk"], mesh=mesh)
    return out


def _small_model(pl):
    from ssg_tpu_torch import models

    model = models.create("resnet50", **pl["model_kw"])
    model.load_state_dict(pl["state"])
    return model


def _bn_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def dp_scenarios(mesh, pl) -> dict:
    """Train steps over ``mesh`` (SGD, so an update is linear in the
    gradient) for each of the payload's scenarios, then extraction and the
    mesh ``Evaluator``; every rank returns its own view."""
    from ssg_tpu_torch import api
    from ssg_tpu_torch.data import datasets
    from ssg_tpu_torch.parallel.dp import shard_batch
    from ssg_tpu_torch.train.trainer import make_train_step

    out = {}
    for name, sc in pl["scenarios"].items():
        model = _small_model({**pl, "model_kw": {**pl["model_kw"], **sc.get("model_kw", {})},
                              "state": sc.get("state", pl["state"])})
        opt = torch.optim.SGD(model.parameters(), lr=pl["lr"])
        step = make_train_step(model, opt, num_parts=3, ce_weight=sc.get("ce_weight", 0.0),
                               height=pl["h"], width=pl["w"], mesh=mesh,
                               remat=sc.get("remat", False))
        gen = torch.Generator().manual_seed(sc["seed"]) if "seed" in sc else None
        losses, params = [], []
        for images, labels, crops in sc["steps"]:
            crops = None if crops is None else tuple(torch.from_numpy(c) for c in crops)
            m = step(shard_batch(mesh, torch.from_numpy(images)), torch.from_numpy(labels).long(),
                     generator=gen, crops=crops)
            losses.append(float(m["loss"]))
            params.append({k: v.detach().clone() for k, v in model.named_parameters()})
        out[name] = {"losses": losses, "params": params[-1], "first": params[0],
                     "bn": _bn_stats(model)}
    model = _small_model(pl)
    out["extract"] = api.extract_features(model, pl["batches"], device="cpu", mesh=mesh)[0]
    tgt = datasets.create("dukemtmc", scale="tiny", seed=2)
    ev = api.Evaluator(model, batch_size=pl["eval_batch"], device="cpu", mesh=mesh)
    res = ev.evaluate(tgt, rerank=True)
    out["evaluator"] = (res["mAP"], res["cmc"], ev.batch_size)
    return out


def cli_ssg(rank, port, pl) -> dict:
    """``cli.selftraining --data_parallel`` over ``--multihost --dist_*``
    (or a mesh of one where ``port`` is None), recording the features and
    labels of every clustering."""
    import os

    from ssg_tpu_torch.cli import selftraining
    from ssg_tpu_torch.train import ssg_loop

    seen = []
    inner = ssg_loop.streaming_cluster_groups

    def record(feats, **kw):
        res = inner(feats, **kw)
        seen.append((feats.clone(), res[0], res[1], res[2]))
        return res

    ssg_loop.streaming_cluster_groups = record
    argv = pl["argv"] + ["--data_parallel", "--logs_dir", os.path.join(pl["logs"], f"rank{rank}")]
    if port is not None:
        argv += ["--multihost", "--dist_coordinator", f"localhost:{port}",
                 "--dist_num_processes", str(pl["nprocs"]), "--dist_process_id", str(rank)]
    try:
        rc = selftraining.main(argv)
    finally:
        ssg_loop.streaming_cluster_groups = inner
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"rc": rc, "clusterings": seen}
