"""The SSG self-training loop: extract -> re-rank -> cluster -> fine-tune.

Counterpart of ``ssg_tpu/train/ssg_loop.py``, the rebuild of the
reference's [selftraining.py] main loop (SURVEY.md §3.1). Each iteration
extracts the target train set's part embeddings (eval mode), runs the
per-group analytics on the card (``api.cluster_groups``: distance,
k-reciprocal re-ranking with the CUDA L1 kernel, eps, DBSCAN), joins the
groups' pseudo-labels, fine-tunes with P x K batches and a batch-hard
triplet per branch (train mode), evaluates and writes a checkpoint.

Pseudo-label join rule: the whole-body group decides which images take
part in fine-tuning; each branch is then trained against its own group's
labels, remapped to a dense range, with its noise masked.

The model is an ``nn.Module`` updated in place; its mode is switched
between eval (extract, evaluation) and train (fine-tuning) here and in the
entry points, and a ``fused_eval`` model refolds its blocks after every
update (``models/resnet.py``).

``data_parallel`` runs the loop over the ranks of ``parallel.make_mesh``
(torchrun's process group, else a mesh of one), as the JAX package's mesh
does: rank 0's weights are broadcast once, the extraction is sharded, the
clustering is ``streaming_cluster_groups`` over the mesh, fine-tuning is
the data-parallel step and evaluation the mesh ``Evaluator``; only rank 0
writes the checkpoint, and a resume reads the same file on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ssg_tpu_torch import api
from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.data.sampler import RandomIdentitySampler
from ssg_tpu_torch.parallel import make_mesh, replicate, streaming_cluster_groups
from ssg_tpu_torch.train.schedule import load_optimizer_state, lr_at, make_optimizer
from ssg_tpu_torch.train.semi import affiliate_clusters
from ssg_tpu_torch.train.trainer import Trainer, make_train_step
from ssg_tpu_torch.utils.serialization import load_checkpoint, save_checkpoint


@dataclasses.dataclass
class SSGConfig:
    """Flags mirror the reference's argparse set (SURVEY.md §5 config row);
    fields and defaults are the JAX package's."""

    iterations: int = 30
    epochs: int = 70
    batch_size: int = 64
    num_instances: int = 4  # K in the P x K sampler
    k1: int = 20
    k2: int = 6
    lambda_value: float = 0.1
    rho: float = 1.6e-3
    # Per-iteration eps-quantile growth: rho_it = rho * (1+rho_growth)^it.
    # 0 = the reference's fixed rho.
    rho_growth: float = 0.0
    min_samples: int = 4
    margin: float = 0.3
    lr: float = 6e-5
    # LR schedule (train/schedule.py): constant, or 'step' (the open-reid
    # family's StepLR), applied within each clustering iteration.
    lr_schedule: str = "constant"
    lr_step_size: int = 40
    lr_gamma: float = 0.1
    warmup_epochs: int = 0
    weight_decay: float = 5e-4
    num_parts: int = 3
    height: int = 256
    width: int = 128
    print_freq: int = 10
    seed: int = 0
    eval_rerank: bool = False
    logs_dir: str = "logs"  # holds checkpoint.pth and model_best.pth
    data_parallel: bool = False  # over the ranks of parallel.make_mesh


def _dense_remap_keep_noise(labels: np.ndarray) -> np.ndarray:
    """Remap non-negative labels to 0..K-1 (order-preserving); -1 stays -1."""
    uniq = np.unique(labels[labels >= 0])
    lut = {int(v): i for i, v in enumerate(uniq)}
    return np.asarray([lut[int(v)] if v >= 0 else -1 for v in labels], dtype=np.int32)


def join_rule(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SSG pseudo-label join: the whole-body group (row 0) decides dataset
    membership; part groups keep their own labels with noise as -1, masked
    inside that branch's triplet loss (SURVEY.md §3.1 [MED]).

    Args:   labels (num_groups, N) int32, -1 = DBSCAN noise.
    Returns (keep mask (N,), kept_idx, kept_labels (num_groups, K) densely
    remapped per group with noise preserved).
    """
    keep = labels[0] >= 0
    kept_idx = np.flatnonzero(keep)
    kept_labels = np.stack([_dense_remap_keep_noise(lab[keep]) for lab in labels])
    return keep, kept_idx, kept_labels


def run_ssg(model, tgt, config: SSGConfig | None = None, logger=None, evaluate_every: int = 1,
            one_shot: dict[int, int] | None = None, ce_weight: float = 0.0,
            resume_from: str | None = None, device=None):
    """Run SSG adaptation of ``model`` (holding the source-trained weights)
    on target dataset ``tgt``, on ``device`` (the card unless ``"cpu"``).
    The model is moved there and updated in place. Returns ``(optimizer,
    history)``: one entry per iteration run, with the JAX package's keys
    (``iteration``, ``clusters`` as (count, eps) pairs, ``kept``,
    ``seconds`` up to evaluation, ``mAP``/``rank1`` when evaluated) and the training's
    ``steps``, mean ``loss`` and the iteration's ``extract_seconds``,
    ``cluster_seconds``, ``train_seconds`` and ``eval_seconds``.

    SSG++ ([semitraining.py] rebuild): pass ``one_shot`` ({train index ->
    true pid}, see ``train/semi.one_shot_subset``) and ``ce_weight`` > 0;
    the model must have classifier heads sized to the identity count.

    ``resume_from``: path of a loop checkpoint (``logs_dir/checkpoint.pth``:
    model, optimizer state and iteration, written each iteration below);
    the run continues from the next clustering iteration with the
    optimizer state intact.
    """
    cfg = config or SSGConfig()
    mesh = None
    if cfg.data_parallel:
        mesh = make_mesh(device=device)
        if cfg.batch_size % mesh.size:
            raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the mesh size "
                             f"{mesh.size} under data_parallel")
        print(f"data-parallel over {mesh.size} ranks ({mesh.backend or 'one process'})")
    dev = resolve_device(device) if mesh is None else mesh.device
    semi = one_shot is not None and ce_weight > 0.0
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(model.parameters(), cfg.lr, weight_decay=cfg.weight_decay)
    start_iter = 0
    if resume_from is not None:
        # On the host: the optimizer's load moves each tensor to its
        # parameter's device, the step counters to where AdamW reads them.
        ckpt = load_checkpoint(resume_from, device="cpu")
        model.load_state_dict(ckpt["model"])
        load_optimizer_state(optimizer, ckpt["optimizer"])
        start_iter = int(ckpt["iteration"]) + 1
        print(f"Resumed from {resume_from}: continuing at iteration {start_iter}")
    if mesh is not None:
        replicate(mesh, model)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    step = make_train_step(model, optimizer, margin=cfg.margin, num_parts=cfg.num_parts,
                           ce_weight=ce_weight if semi else 0.0, height=cfg.height,
                           width=cfg.width, mesh=mesh)
    trainer = Trainer(step, optimizer, print_freq=cfg.print_freq, logger=logger, device=dev,
                      mesh=mesh)
    history = []
    best_map = -1.0

    for it in range(start_iter, cfg.iterations):
        t_iter = time.time()

        # 1) Extract multi-branch features for the unlabeled target train set.
        pre = Preprocessor(tgt, items=tgt.train, batch_size=cfg.batch_size)
        feats, _, cams, fnames = api.extract_features(model, pre, device=dev, mesh=mesh)
        n = feats.shape[1]
        t_extract = time.time() - t_iter

        # 2) Per feature group: k-reciprocal re-rank + auto-eps DBSCAN on the card.
        t_cluster = time.time()
        rho_it = cfg.rho * (1.0 + cfg.rho_growth) ** it
        analytics = dict(k1=cfg.k1, k2=cfg.k2, lambda_value=cfg.lambda_value, rho=rho_it,
                         min_samples=cfg.min_samples, device=dev)
        if mesh is not None:
            labels, counts, epss = streaming_cluster_groups(feats, mesh=mesh, **analytics)
        else:
            labels, counts, epss = api.cluster_groups(feats, **analytics)
        cluster_info = list(zip(counts, epss))
        t_cluster = time.time() - t_cluster

        # 3) Join rule: whole-body group decides membership, part groups keep
        #    their own labels with noise masked per branch.
        keep, kept_idx, kept_labels = join_rule(labels)
        if semi:
            # SSG++: extra label row of affiliated true identities (CE term).
            id_labels = affiliate_clusters(labels[0], one_shot)
            kept_labels = np.concatenate([kept_labels, id_labels[kept_idx][None]], axis=0)
            if logger is not None:
                logger.metric(kind="affiliation", iteration=it,
                              supervised=int((id_labels[kept_idx] >= 0).sum()))
        keep_rate = float(keep.sum()) / max(n, 1)
        for g, (nc, eps) in enumerate(cluster_info):
            print(f"Iteration {it} group {g}: {nc} clusters, eps={eps:.4f}, "
                  f"kept {keep.sum()}/{n} images ({keep_rate:.0%}, {t_cluster:.1f}s on device)")
        if logger is not None:
            logger.metric(kind="cluster", iteration=it,
                          clusters=[int(c) for c, _ in cluster_info],
                          eps=[float(e) for _, e in cluster_info],
                          kept=int(keep.sum()), total=int(n), keep_rate=keep_rate,
                          rho=rho_it, cluster_seconds=t_cluster)
        if keep.sum() < cfg.num_instances * 2:
            print(f"Iteration {it}: too few clustered images; skipping training")
            continue

        # 4) Fine-tune: P x K batches over whole-body pseudo-ids, per-branch
        #    triplet against each branch's own labels (SURVEY.md §3.4).
        kept_items = [(fnames[i], int(kept_labels[0, j]), int(cams[i]))
                      for j, i in enumerate(kept_idx)]
        sampler = RandomIdentitySampler(kept_items, num_instances=cfg.num_instances,
                                        seed=cfg.seed + it)
        if len(sampler) < cfg.batch_size:
            # P x K epochs are num_ids * K long; fewer clusters than P means
            # zero full batches and silent no-op training. Surface it.
            print(f"Iteration {it}: only {len(sampler)} P x K samples for batch_size "
                  f"{cfg.batch_size}; lower --batch_size or raise --rho; skipping training")
            continue
        sub_pre = Preprocessor(tgt, items=[(fnames[i], 0, 0) for i in kept_idx],
                               batch_size=cfg.batch_size)

        def batch_iter(epoch_seed):
            # Epoch order keyed on (seed, iteration, epoch): resumed runs
            # replay identical epochs regardless of sampler history.
            for idx in sampler.batches(cfg.batch_size, seed=epoch_seed):
                images, _, _ = sub_pre.gather(idx)
                yield images, kept_labels[:, idx]

        t_train = time.time()
        steps, loss_sum = 0, 0.0
        for epoch in range(cfg.epochs):
            lr = lr_at(epoch, cfg.lr, cfg.lr_schedule, cfg.lr_step_size, cfg.lr_gamma,
                       cfg.warmup_epochs)
            res = trainer.train(epoch, batch_iter(cfg.seed + 1000 * it + epoch), generator,
                                lr=lr)
            steps += res["steps"]
            loss_sum += res["loss"] * res["steps"]
        t_train = time.time() - t_train

        # 5) Evaluate + checkpoint per iteration (SURVEY.md §3.1 tail).
        t_eval = time.time()
        entry = {"iteration": it, "clusters": cluster_info, "kept": int(keep.sum()),
                 "seconds": time.time() - t_iter, "steps": steps,
                 "loss": loss_sum / max(steps, 1)}
        is_best = False
        if tgt.query and (it % evaluate_every == 0 or it == cfg.iterations - 1):
            ev = api.Evaluator(model, batch_size=cfg.batch_size, device=dev, mesh=mesh)
            res = ev.evaluate(tgt, rerank=cfg.eval_rerank, logger=logger)
            entry["mAP"] = res["mAP"]
            entry["rank1"] = float(res["cmc"][0])
            is_best = res["mAP"] > best_map
            best_map = max(best_map, res["mAP"])
        t_eval = time.time() - t_eval
        if mesh is None or mesh.rank == 0:
            save_checkpoint({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                             "iteration": it},
                            is_best, fpath=os.path.join(cfg.logs_dir, "checkpoint.pth"))
        entry.update(extract_seconds=t_extract, cluster_seconds=t_cluster,
                     train_seconds=t_train, eval_seconds=t_eval)
        history.append(entry)

    return optimizer, history
