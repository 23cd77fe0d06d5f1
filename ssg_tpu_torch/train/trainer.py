"""Training loop: per-branch batch-hard triplet on pseudo-labels.

Counterpart of ``ssg_tpu/train/trainer.py``, which rebuilds the reference's
[reid/trainers.py] (SURVEY.md §2 #5, §3.4). One step holds the augmentation
on the card (crop, flip, normalise), the train-mode forward of all part
branches, a batch-hard triplet loss per branch against that branch's own
pseudo-labels (plus the SSG++ cross-entropy on the identity row, or the
OIM term), the backward pass and the AdamW update, in PyTorch's idiom: the
step updates the model, the optimizer and the OIM table in place. Nothing
in it waits for the device; ``Trainer`` reads the losses back only every
``print_freq`` steps. The host renders uint8 batches on a producer thread
(``data.prefetch``) into pinned memory and uploads them without blocking.

bf16 policy: the model computes its backbone in bf16 from fp32 master
weights, the optimizer state is fp32 and the losses are fp32.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.data.prefetch import prefetch
from ssg_tpu_torch.loss.oim import oim_loss
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss
from ssg_tpu_torch.train.schedule import set_learning_rate
from ssg_tpu_torch.utils.meters import AverageMeter


def make_train_step(model, optimizer: torch.optim.Optimizer, margin: float = 0.3,
                    num_parts: int = 3, ce_weight: float = 0.0, height: int = 256,
                    width: int = 128, remat: bool = False, oim_weight: float = 0.0,
                    oim_temperature: float = 0.1, oim_momentum: float = 0.5,
                    lut: torch.Tensor | None = None) -> Callable:
    """Build the SSG train step.

    ``step(images_u8 (B, H, W, 3), labels, generator, crops=None) ->
    {"loss", "prec"}`` (0-dim tensors on the device). ``labels[g]``,
    g < num_parts, is branch g's pseudo-label set (SURVEY.md §3.4), -1 for
    noise. When ``ce_weight > 0`` and the model has classifier heads,
    ``labels`` carries one extra row ``labels[num_parts]`` of true identity
    labels (-1 = unknown, masked) and a per-branch cross-entropy on it is
    added: the SSG++ supervised term (``train/semi.py``). The crops and
    flips are drawn from ``generator`` (on the images' device), or taken
    from ``crops = (boxes, flips)`` as ``transforms.draw_crops`` returns
    them. Dropout draws from the device's default generator.

    ``oim_weight > 0`` adds the Online Instance Matching loss
    (``loss/oim.py``) on the whole-body embedding ``emb[0]`` in fp32,
    L2-normalised (floor 1e-12), against the identity row
    ``labels[num_parts]``. ``lut`` is its (num_classes, F) fp32 table on the
    model's device; the step moves the matched rows in place after the
    optimizer step.

    ``remat``: each residual block recomputes its activations in the
    backward pass (``models/resnet.py``): less memory for one more forward
    of the backbone, with the same loss, gradients and BatchNorm statistics.
    """
    if oim_weight > 0.0 and lut is None:
        raise ValueError("oim_weight > 0 needs the OIM table: pass lut=")

    def step(images_u8: torch.Tensor, labels: torch.Tensor, generator=None, crops=None):
        if crops is None:
            crops = transforms.draw_crops(generator, *images_u8.shape[:3])
        x = transforms.normalize_float(
            transforms.crop_flip(images_u8, *crops, height, width), torch.float32)
        model.train()
        out = model(x, remat=remat)
        emb = out["embeddings"]  # (num_parts, B, F)
        total = emb.new_zeros(())
        precs = []
        for g in range(num_parts):
            loss_g, prec_g = batch_hard_triplet_loss(emb[g], labels[g], margin)
            total = total + loss_g
            precs.append(prec_g)
        if ce_weight > 0.0 and "logits" in out:
            id_labels = labels[num_parts]
            mask = id_labels >= 0
            n = mask.sum().clamp_min(1)
            for g in range(num_parts):
                ce = F.cross_entropy(out["logits"][g], id_labels.clamp_min(0), reduction="none")
                total = total + ce_weight * torch.where(mask, ce, 0.0).sum() / n
        new_lut = None
        if oim_weight > 0.0:
            w = emb[0].float()  # whole-body branch
            w = w / w.norm(dim=1, keepdim=True).clamp_min(1e-12)
            oim, new_lut = oim_loss(lut, w, labels[num_parts], oim_temperature, oim_momentum)
            total = total + oim_weight * oim
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        if new_lut is not None:
            lut.copy_(new_lut)
        return {"loss": total.detach(), "prec": torch.stack(precs).mean()}

    return step


class Trainer:
    """Epoch loop with the reference's meters and printing (SURVEY.md §3.4)."""

    def __init__(self, step_fn: Callable, optimizer: torch.optim.Optimizer,
                 print_freq: int = 10, logger=None, device=None):
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.print_freq = print_freq
        self.logger = logger
        self.device = resolve_device(device)

    def _host(self, batch_iter):
        """(images, labels) numpy batches -> CPU tensors, pinned when the
        step runs on the card (on the producer thread, off the step's way)."""
        pin = self.device.type == "cuda"
        for images, labels in batch_iter:
            images = torch.from_numpy(np.ascontiguousarray(images))
            labels = torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int64))
            yield (images.pin_memory(), labels.pin_memory()) if pin else (images, labels)

    def train(self, epoch: int, batch_iter, generator: torch.Generator,
              lr: float | None = None, prefetch_depth: int = 2) -> dict:
        """``batch_iter`` yields (images_u8, labels (num_parts, B)) host
        arrays. ``lr``: the learning rate for this epoch
        (``train/schedule.py``). ``prefetch_depth``: batches rendered ahead
        on a producer thread; 0 renders in line. Returns the epoch's mean
        ``loss`` and ``prec`` and its number of ``steps``."""
        if lr is not None:
            set_learning_rate(self.optimizer, lr)
        batches = self._host(batch_iter)
        if prefetch_depth > 0:
            batches = prefetch(batches, depth=prefetch_depth)
        losses, precs, batch_time = AverageMeter(), AverageMeter(), AverageMeter()
        end = time.time()
        pending = []  # device-side metrics, read back only at print_freq
        steps = 0
        for i, (images, labels) in enumerate(batches):
            metrics = self.step_fn(images.to(self.device, non_blocking=True),
                                   labels.to(self.device, non_blocking=True), generator)
            pending.append((i, images.shape[0], metrics))
            steps += 1
            batch_time.update(time.time() - end)
            end = time.time()
            if (i + 1) % self.print_freq == 0:
                self._drain(epoch, pending, losses, precs)
                print(
                    f"Epoch: [{epoch}][{i + 1}]\t"
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                    f"Loss {losses.val:.3f} ({losses.avg:.3f})\t"
                    f"Prec {precs.val:.2%} ({precs.avg:.2%})"
                )
        self._drain(epoch, pending, losses, precs)
        return {"loss": losses.avg, "prec": precs.avg, "steps": steps}

    def _drain(self, epoch, pending, losses, precs):
        for i, bs, metrics in pending:
            loss = float(metrics["loss"])
            prec = float(metrics["prec"])
            losses.update(loss, bs)
            precs.update(prec, bs)
            if self.logger is not None:
                self.logger.metric(kind="train_step", epoch=epoch, step=i, loss=loss, prec=prec)
        pending.clear()
