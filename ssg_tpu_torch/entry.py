"""Entry points of the port: a forward on the flagship model, and the
multi-rank dry run.

Counterpart of the repository root's ``__graft_entry__.py``:

* ``entry()`` returns ``(fn, (model, images_u8))``: ``fn`` is
  ``test_transform`` followed by the eval forward's ``"embeddings"``
  (num_parts, B, F), on the fp32 SSG ResNet-50 with 3 parts (random
  weights from seed 0) and uint8 zeros of shape (8, 256, 128, 3), on the
  card unless ``device="cpu"``.
* ``dryrun_multichip(n)`` spawns ``n`` gloo ranks on the CPU (JAX's dry run
  forces a virtual CPU mesh; this forces CPU ranks) and runs on each: one
  data-parallel train step of the fp32 ResNet-50 at 64x32, batch 2n, one
  pseudo-identity per 4 images, whose loss must be finite (at n = 2 the
  batch holds one identity, so the batch-hard triplet has no negative, the
  loss is 0 and the step only exercises the plumbing, as JAX's does at
  n = 2); then the dense
  sharded chain (``sharded_re_ranking`` -> ``sharded_select_eps`` ->
  ``sharded_dbscan``) against ``streaming_cluster(chunk=64)`` over the
  ranks, at 256 n + 3 points of 32-d seeded blobs, under JAX's gates: on
  every seed tried (up to 8) at least 0.995 of the labels agree and eps
  within 1e-5 relative, and on at least one seed the labels are equal.
  The two chains reduce in different orders, so fp32 near-ties can flip a
  few labels on a seed; a regression of the stripe arithmetic disagrees in
  mass.

    python -m ssg_tpu_torch.entry

runs ``entry()``'s forward on the card and ``dryrun_multichip(2)``.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

from ssg_tpu_torch import models, resolve_device
from ssg_tpu_torch.data import transforms

# A dry-run rank group's bound, start-up included.
DRYRUN_TIMEOUT_S = 600.0


def entry(device=None):
    """``(fn, (model, images_u8))``: ``fn(model, images_u8)`` is the eval
    forward's (3, B, 2048) L2-normalised embeddings of SSG ResNet-50."""
    dev = resolve_device(device)
    model = models.create("resnet50", num_features=0, num_parts=3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.eval().to(dev, memory_format=torch.channels_last)
    images = torch.zeros((8, 256, 128, 3), dtype=torch.uint8, device=dev)

    @torch.no_grad()
    def fn(model, images_u8):
        return model(transforms.test_transform(images_u8))["embeddings"]

    return fn, (model, images)


def _train_step_loss(mesh, batch: int | None = None) -> float:
    """One data-parallel train step (fp32 ResNet-50, 64x32, batch 2P unless
    ``batch`` is given): its loss."""
    from ssg_tpu_torch.parallel.dp import shard_batch
    from ssg_tpu_torch.train.schedule import make_optimizer
    from ssg_tpu_torch.train.trainer import make_train_step

    h, w = 64, 32
    batch = batch or 2 * mesh.size
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    step = make_train_step(model.to(mesh.device), make_optimizer(model.parameters(), 6e-5),
                           num_parts=3, height=h, width=w, mesh=mesh)
    images = (np.random.default_rng(0).random((batch, h, w, 3)) * 255).astype(np.uint8)
    # One pseudo-identity per 4 images, truncated to the batch.
    labels = np.tile((np.arange(batch) // 4)[None, :], (3, 1))
    metrics = step(shard_batch(mesh, torch.from_numpy(images).to(mesh.device)),
                   torch.from_numpy(labels).to(mesh.device),
                   generator=torch.Generator(device=mesh.device).manual_seed(1))
    return float(metrics["loss"])


def _chains(mesh) -> dict:
    """The dense sharded chain against streaming over the ranks, under
    JAX's gates (the module docstring)."""
    from ssg_tpu_torch.parallel import (sharded_dbscan, sharded_re_ranking, sharded_select_eps,
                                        streaming_cluster)

    n_pts = 256 * mesh.size + 3
    k1, k2, rho = 20, 6, 1.6e-3
    agreements = []
    for seed in range(8):
        gen = np.random.default_rng(seed)
        centers = gen.normal(size=(32, 32))
        x = centers[gen.integers(0, 32, n_pts)] + 0.3 * gen.normal(size=(n_pts, 32))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        feats = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
        dist = sharded_re_ranking(feats, mesh, k1=k1, k2=k2)
        eps = float(sharded_select_eps(dist, mesh, rho=rho))
        labels, n_clusters = sharded_dbscan(dist, eps, mesh, min_samples=4)
        s_labels, s_clusters, s_eps = streaming_cluster(feats, k1=k1, k2=k2, rho=rho,
                                                        min_samples=4, chunk=64, mesh=mesh)
        labels = labels.cpu().numpy()
        agree = float((labels == s_labels).mean())
        agreements.append(agree)
        if agree < 0.995:
            raise RuntimeError(f"dense/streaming label agreement {agree:.4f} < 0.995 at seed "
                               f"{seed}: mass disagreement, not fp ties")
        if abs(eps - s_eps) > 1e-5 * eps:
            raise RuntimeError(f"eps mismatch: dense {eps} against streaming {s_eps}")
        if np.array_equal(labels, s_labels):
            return {"points": n_pts, "seed": seed, "agreement": agreements,
                    "clusters_dense": int(n_clusters), "clusters_streaming": int(s_clusters),
                    "eps": eps}
    raise RuntimeError(f"no seed of 8 gave exact dense/streaming equality at N={n_pts}; every "
                       "seed agreed >= 0.995 (fp-tie flips), but exactness is the dry run's bar")


def _dryrun_rank(rank: int, n: int, port: int, out_dir: str) -> None:
    """One rank of the dry run: join the gloo group, run, save the result;
    a failure leaves its traceback beside it."""
    import torch.distributed as dist

    from ssg_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S))
    try:
        mesh = make_mesh(n, device="cpu", backend="gloo")
        loss = _train_step_loss(mesh)
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss: {loss}")
        torch.save({"loss": loss, **_chains(mesh)}, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run (the module docstring) on ``n_devices`` gloo ranks on
    the CPU; raises if a rank fails or the group outlives DRYRUN_TIMEOUT_S.
    Returns rank 0's result (every rank's is the same)."""
    import torch.multiprocessing as mp

    # The ranks' target by its module's own name, also when this module runs
    # as __main__ (python -m): a spawned child imports it by that name.
    from ssg_tpu_torch.entry import _dryrun_rank as target

    with tempfile.TemporaryDirectory(prefix="ssg_dryrun_") as out_dir:
        ctx = mp.start_processes(target, args=(n_devices, _free_port(), out_dir),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip({n_devices}) outlived "
                                       f"{DRYRUN_TIMEOUT_S} s")
        except BaseException as e:
            errs = [open(os.path.join(out_dir, name)).read()
                    for name in sorted(os.listdir(out_dir)) if name.endswith(".err")]
            raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n" + "\n".join(errs)) from e
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(n_devices)]
    if any(r != results[0] for r in results[1:]):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks disagree: {results}")
    r = results[0]
    print(f"dryrun_multichip({n_devices}): train loss={r['loss']:.3f}, "
          f"clusters={r['clusters_dense']} (dense) / {r['clusters_streaming']} (streaming) "
          f"over {r['points']} points — OK", flush=True)
    return r


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry forward:", tuple(out.shape), torch.cuda.get_device_name(0))
    dryrun_multichip(2)
