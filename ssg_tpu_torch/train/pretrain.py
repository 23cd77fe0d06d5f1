"""Supervised source pretraining.

Counterpart of ``ssg_tpu/train/pretrain.py``. The reference workflow starts
from a ResNet-50 re-ID model supervised-trained on the source dataset
(SURVEY.md §0 step 1; the reference consumes it through ``--resume``).
This trains it: P x K batches over the true source identities, the SSG
train step with a batch-hard triplet per branch plus either a
cross-entropy on every branch's identity logits (``loss="softmax"``, the
softmax + triplet re-ID baseline) or OIM on the whole-body embedding
(``loss="oim"``, no classifier heads), a step-decayed learning rate, and a
checkpoint at the end.

The decay is indexed by optimizer steps, as the JAX package's optax
schedule is: rate x0.1 once ``e * (len(train) // batch_size)`` updates have
been taken, for each ``e`` in ``lr_decay_epochs``. The P x K sampler yields
about ``num_ids * K / batch_size`` batches an epoch, not ``len(train) /
batch_size``, so the decay lands at another sampler epoch than ``e``
(ROADMAP C); the port keeps the reference's steps.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.data.preprocessor import Preprocessor
from ssg_tpu_torch.data.sampler import RandomIdentitySampler
from ssg_tpu_torch.train.schedule import make_optimizer, set_learning_rate
from ssg_tpu_torch.train.trainer import Trainer, make_train_step
from ssg_tpu_torch.utils.serialization import save_checkpoint


@dataclasses.dataclass
class PretrainConfig:
    """Fields and defaults are the JAX package's."""

    epochs: int = 70
    batch_size: int = 64
    num_instances: int = 4
    margin: float = 0.3
    ce_weight: float = 1.0
    # "softmax": per-branch CE on identity logits (classifier heads).
    # "oim": Online Instance Matching on the whole-body embedding
    # (loss/oim.py); the model needs no classifier heads (num_classes=0).
    # The triplet runs in both modes.
    loss: str = "softmax"
    oim_temperature: float = 0.1
    oim_momentum: float = 0.5
    lr: float = 3.5e-4
    weight_decay: float = 5e-4
    lr_decay_epochs: tuple = (40, 60)  # step decay x0.1 (re-ID convention)
    num_parts: int = 3
    height: int = 256
    width: int = 128
    print_freq: int = 10
    seed: int = 0
    logs_dir: str = "logs"


def step_decay(lr: float, boundaries: list[int], count: int) -> float:
    """optax's ``piecewise_constant_schedule(lr, {b: 0.1 for b in
    boundaries})`` at update ``count``, in its fp32 arithmetic: the rate is
    scaled by 0.1 for each boundary that ``count`` has reached."""
    v = np.float32(lr)
    for b in sorted(set(boundaries)):
        if count >= b:
            v = np.float32(0.1) * v
    return float(v)


def run_pretrain(model, src, config: PretrainConfig | None = None, logger=None, device=None):
    """Supervised training of ``model`` on the source identities of
    ``src``, on ``device`` (the card unless ``"cpu"``); the model is moved
    there and updated in place.

    In softmax mode the model needs ``num_classes`` equal to the number of
    source identities. Writes ``logs_dir/source_checkpoint.pth`` (and its
    ``model_best.pth`` copy): ``{"model", "optimizer", "epoch"}``, plus the
    OIM table as ``"lut"`` in OIM mode. Returns ``(optimizer, history, lut)``:
    one history entry per epoch (``epoch``, ``steps``, mean ``loss`` and
    ``prec``, the rate of each step as ``lrs``, ``seconds``), and the OIM
    table (None in softmax mode).
    """
    cfg = config or PretrainConfig()
    if cfg.loss not in ("softmax", "oim"):
        raise ValueError(f"unknown pretraining loss {cfg.loss!r}")
    dev = resolve_device(device)
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)

    # Dense 0..K-1 identity labels (open-reid relabel convention).
    pids = sorted({p for _, p, _ in src.train})
    to_dense = {p: i for i, p in enumerate(pids)}
    items = [(f, to_dense[p], c) for f, p, c in src.train]

    steps_per_epoch = max(len(items) // cfg.batch_size, 1)
    boundaries = [e * steps_per_epoch for e in cfg.lr_decay_epochs]
    optimizer = make_optimizer(model.parameters(), cfg.lr, weight_decay=cfg.weight_decay)
    oim = cfg.loss == "oim"
    lut = None
    if oim:
        lut = torch.zeros((len(pids), model.embedding_dim), dtype=torch.float32, device=dev)
    train_step = make_train_step(
        model, optimizer, margin=cfg.margin, num_parts=cfg.num_parts,
        ce_weight=0.0 if oim else cfg.ce_weight, height=cfg.height, width=cfg.width,
        oim_weight=1.0 if oim else 0.0, oim_temperature=cfg.oim_temperature,
        oim_momentum=cfg.oim_momentum, lut=lut)
    lrs = []

    def step(images, labels, generator, crops=None):
        # The rate of update number len(lrs), set before the update.
        lrs.append(step_decay(cfg.lr, boundaries, len(lrs)))
        set_learning_rate(optimizer, lrs[-1])
        return train_step(images, labels, generator, crops)

    trainer = Trainer(step, optimizer, print_freq=cfg.print_freq, logger=logger, device=dev)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    sampler = RandomIdentitySampler(items, num_instances=cfg.num_instances, seed=cfg.seed)
    pre = Preprocessor(src, items=[(f, 0, 0) for f, _, _ in items], batch_size=cfg.batch_size)
    labels_all = np.asarray([p for _, p, _ in items], dtype=np.int32)

    def batch_iter():
        for idx in sampler.batches(cfg.batch_size):
            images, _, _ = pre.gather(idx)
            pid_row = labels_all[idx][None]
            # num_parts triplet rows and one identity row (the same labels:
            # supervised pretraining trains every branch on true ids).
            yield images, np.concatenate([np.repeat(pid_row, cfg.num_parts, axis=0), pid_row])

    history = []
    for epoch in range(cfg.epochs):
        t0, first = time.time(), len(lrs)
        res = trainer.train(epoch, batch_iter(), generator)
        entry = {"epoch": epoch, "steps": res["steps"], "loss": res["loss"], "prec": res["prec"],
                 "lrs": lrs[first:], "seconds": time.time() - t0}
        history.append(entry)
        if logger is not None:
            logger.metric(kind="pretrain_epoch", **entry)

    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "epoch": cfg.epochs}
    if oim:
        state["lut"] = lut
    save_checkpoint(state, is_best=True, fpath=os.path.join(cfg.logs_dir, "source_checkpoint.pth"))
    return optimizer, history, lut
