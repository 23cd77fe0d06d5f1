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

CUDA graphs: on the card the step is captured once into three CUDA graphs
(forward, backward, optimizer) that share one memory pool, and replayed in
that order at every later call, so the host launches three graphs where it
would launch some 1,400 kernels. The kernels and the math are the eager
step's. The crops are still drawn eagerly on the caller's generator (the
same random stream), and each call copies its images, labels, boxes and
flips into the graphs' static inputs and returns copies of the static loss
and precision. The graphs are used when the parameters are on the card,
the optimizer is ``capturable`` (``train/schedule.py``), there is no mesh
of more than one rank, ``remat`` is off and no module of the model has a
forward or backward hook (nor a global one); everything else runs the
eager step. The first call of a signature (the images' shape and dtype,
the labels' shape, whether crops are passed, each param group's learning
rate, decay, betas, eps and ``capturable``, and the TF32 and cuDNN
determinism flags, all of which a capture bakes in) runs eager: a real
step that initialises AdamW's state and cuDNN's plans. The second captures
the graphs and replays them once (a capture runs nothing); later calls
replay. A call with another signature frees the graphs and runs eager, so
a new learning rate is captured anew, never replayed stale. A replay
writes the parameters, AdamW's state and the BatchNorm statistics without
bumping their ``_version``; the model's no-grad weight casts and BN folds
key on it, so the step bumps the parameters and buffers it wrote after
each replay. The capture runs in CUDA's thread-local mode, so the feed's
producer thread may pin and free host memory meanwhile; the backward is
launched onto the capturing stream from autograd's device thread.

Spans (``utils.profiling``; they record only under a profiler or
``record_spans()``): ``train.step`` around each call of the step, with
``train.forward``, ``train.backward`` and ``train.optimizer`` inside it
(eager: the launches of each phase; graphed: the crop draw, the input
copies and the forward's replay, the backward's replay, the optimizer's
replay and the version bump); ``Trainer`` adds ``train.feed_wait``,
``train.upload`` and ``train.drain`` on its thread and ``feed.host`` on
the producer's. The step's spans are keyed by the step's index among the
calls of the step function. The counter ``train.graph_replays``
(``GRAPH_REPLAYS``) counts the graphed steps.

bf16 policy: the model computes its backbone in bf16 from fp32 master
weights, the optimizer state is fp32 and the losses are fp32.

Data parallel (``mesh`` of P > 1 ranks, ``parallel/mesh.py``): JAX's step
is the one-device program on the whole batch, split over the mesh, so the
port's DP step computes that same function. Each rank forwards its slice
of the batch; the BatchNorms take global-batch statistics
(``models.layers.data_parallel``); the embeddings (and logits) are
gathered with ``parallel.ring.gather_rows``, so the batch-hard triplet
searches the global batch and the SSG++ cross-entropy divides by the
global count of labelled rows; the crops and flips are drawn for the
global batch from the one generator, then sliced. Every rank computes the
one global loss, each backpropagates through its own slice only, and the
gradients are summed over the ranks (``parallel.dp.all_reduce_grads``), so
every rank takes the same optimizer step.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.data import transforms
from ssg_tpu_torch.data.prefetch import prefetch
from ssg_tpu_torch.loss.oim import oim_loss
from ssg_tpu_torch.models.layers import data_parallel, no_hooks
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss
from ssg_tpu_torch.parallel.dp import all_reduce_grads, shard_batch
from ssg_tpu_torch.parallel.ring import gather_rows
from ssg_tpu_torch.train.schedule import set_learning_rate
from ssg_tpu_torch.utils.meters import AverageMeter
from ssg_tpu_torch.utils.profiling import count, span

GRAPH_REPLAYS = "train.graph_replays"  # the counter of graphed steps


def make_train_step(model, optimizer: torch.optim.Optimizer, margin: float = 0.3,
                    num_parts: int = 3, ce_weight: float = 0.0, height: int = 256,
                    width: int = 128, remat: bool = False, oim_weight: float = 0.0,
                    oim_temperature: float = 0.1, oim_momentum: float = 0.5,
                    lut: torch.Tensor | None = None, mesh=None) -> Callable:
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

    ``remat``: each block of the backbone recomputes its activations in
    the backward pass (``models.layers.remat_block``): less memory for one
    more forward of the backbone, with the same loss, gradients and
    BatchNorm statistics.

    ``mesh``: data parallel over its ranks (the module docstring); the
    model must hold the same weights on every rank (``parallel.dp.
    replicate``). ``images_u8`` is then this rank's slice of the batch,
    while ``labels`` and ``crops`` are the global batch's. Dropout draws
    each rank's rows from its own device generator.

    On the card, without a mesh, ``remat`` or hooks, the step replays CUDA
    graphs from its second call of a signature on (the module docstring).
    The tensors it returns are each call's own.
    """
    if oim_weight > 0.0 and lut is None:
        raise ValueError("oim_weight > 0 needs the OIM table: pass lut=")
    dp = mesh if mesh is not None and mesh.size > 1 else None
    calls = [0]  # the steps taken: each span's key
    modules = list(model.modules())  # where hooks would be missed by a replay
    stats = {}  # device -> the ImageNet mean and std
    graphed = {"signature": None, "graphs": None}

    def step(images_u8: torch.Tensor, labels: torch.Tensor, generator=None, crops=None):
        calls[0] += 1
        with span("train.step", key=calls[0] - 1):
            signature = _signature(images_u8, labels, crops)
            fresh = signature != graphed["signature"]
            graphed["signature"] = signature
            if fresh or not _graphable():
                graphed["graphs"] = None
                return _step(images_u8, labels, generator, crops)
            if graphed["graphs"] is None:
                graphed["graphs"] = _capture(images_u8, labels)
            count(GRAPH_REPLAYS)
            return _replay(graphed["graphs"], images_u8, labels, generator, crops)

    def _signature(images_u8, labels, crops):
        return (tuple(images_u8.shape), images_u8.dtype, tuple(labels.shape), crops is None,
                tuple((g.get("lr"), g.get("weight_decay"), g.get("betas"), g.get("eps"),
                       g.get("capturable"), len(g["params"])) for g in optimizer.param_groups),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)

    def _graphable():
        return (dp is None and not remat
                and all(g.get("capturable", False) and all(q.is_cuda for q in g["params"])
                        for g in optimizer.param_groups)
                and no_hooks(modules, backward=True))

    def _imagenet_stats(device):
        if device not in stats:
            stats[device] = transforms._stats(device)
        return stats[device]

    def _capture(images_u8, labels):
        """The step's three graphs on static inputs, captured in the order
        they replay into one pool. Nothing runs: the inputs are empty."""
        dev, batch = images_u8.device, labels.shape[-1]
        _imagenet_stats(dev)  # built outside the capture: it copies from the host
        g = SimpleNamespace(
            images=torch.empty_like(images_u8), labels=torch.empty_like(labels),
            boxes=torch.empty((batch, 4), dtype=torch.float32, device=dev),
            flips=torch.empty((batch,), dtype=torch.bool, device=dev),
            forward=torch.cuda.CUDAGraph(), backward=torch.cuda.CUDAGraph(),
            optimizer=torch.cuda.CUDAGraph())
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)

        def capturing(graph):
            return torch.cuda.graph(graph, pool=pool, stream=stream,
                                    capture_error_mode="thread_local")

        optimizer.zero_grad(set_to_none=True)  # the backward's .grad are its own
        with capturing(g.forward):
            total, precs, new_lut = _forward(g.images, g.labels, None, (g.boxes, g.flips))
            g.out = torch.stack([total.detach(), torch.stack(precs).mean()])
        with capturing(g.backward):
            total.backward()
        with capturing(g.optimizer):
            optimizer.step()
            if new_lut is not None:
                lut.copy_(new_lut)
        g.written = [q for group in optimizer.param_groups for q in group["params"]]
        g.written += list(model.buffers()) + ([lut] if lut is not None else [])
        return g

    def _replay(g, images_u8, labels, generator, crops):
        with span("train.forward"):
            if crops is None:
                crops = transforms.draw_crops(generator, labels.shape[-1], *images_u8.shape[1:3])
            g.images.copy_(images_u8)
            g.labels.copy_(labels)
            g.boxes.copy_(crops[0])
            g.flips.copy_(crops[1])
            if not model.training:
                model.train()
            g.forward.replay()
        with span("train.backward"):
            g.backward.replay()
        with span("train.optimizer"):
            g.optimizer.replay()
            torch.autograd.graph.increment_version(g.written)
        out = g.out.clone()  # callers keep results: each its own
        return {"loss": out[0], "prec": out[1]}

    def _step(images_u8, labels, generator, crops):
        with span("train.forward"):
            total, precs, new_lut = _forward(images_u8, labels, generator, crops)
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            with data_parallel(dp):
                total.backward()
            if dp is not None:
                all_reduce_grads(dp, [q for group in optimizer.param_groups
                                      for q in group["params"]])
        with span("train.optimizer"):
            optimizer.step()
            if new_lut is not None:
                lut.copy_(new_lut)
        return {"loss": total.detach(), "prec": torch.stack(precs).mean()}

    def _forward(images_u8, labels, generator, crops):
        if crops is None:
            crops = transforms.draw_crops(generator, labels.shape[-1], *images_u8.shape[1:3])
        if dp is not None:
            crops = tuple(shard_batch(dp, t) for t in crops)
        x = transforms.normalize_float(
            transforms.crop_flip(images_u8, *crops, height, width), torch.float32,
            stats=_imagenet_stats(images_u8.device))
        model.train()
        with data_parallel(dp):
            out = model(x, remat=remat)
        emb = gather_rows(dp, out["embeddings"], 1)  # (num_parts, B, F)
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
                logits = gather_rows(dp, out["logits"][g], 0)
                ce = F.cross_entropy(logits, id_labels.clamp_min(0), reduction="none")
                total = total + ce_weight * torch.where(mask, ce, 0.0).sum() / n
        new_lut = None
        if oim_weight > 0.0:
            w = emb[0].float()  # whole-body branch
            w = w / w.norm(dim=1, keepdim=True).clamp_min(1e-12)
            oim, new_lut = oim_loss(lut, w, labels[num_parts], oim_temperature, oim_momentum)
            total = total + oim_weight * oim
        return total, precs, new_lut

    return step


class Trainer:
    """Epoch loop with the reference's meters and printing (SURVEY.md §3.4).

    With ``mesh`` each host batch is sliced to this rank's share before it
    is uploaded (the step is ``make_train_step(..., mesh=mesh)``'s); every
    rank iterates the same batches."""

    def __init__(self, step_fn: Callable, optimizer: torch.optim.Optimizer,
                 print_freq: int = 10, logger=None, device=None, mesh=None):
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.print_freq = print_freq
        self.logger = logger
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device) if mesh is None else mesh.device

    def _host(self, batch_iter):
        """(images, labels) numpy batches -> CPU tensors, pinned when the
        step runs on the card (on the producer thread, off the step's way).
        With a mesh the images are this rank's slice of the batch
        (``parallel.dp.shard_batch``), the labels the whole batch's."""
        pin = self.device.type == "cuda"
        batch_iter = iter(batch_iter)
        while True:
            with span("feed.host"):
                item = next(batch_iter, None)
                if item is None:
                    return
                images, labels = item
                if self.mesh is not None:
                    images = shard_batch(self.mesh, images)
                images = torch.from_numpy(np.ascontiguousarray(images))
                labels = torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int64))
                if pin:
                    images, labels = images.pin_memory(), labels.pin_memory()
            yield images, labels

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
        batches = iter(batches)
        losses, precs, batch_time = AverageMeter(), AverageMeter(), AverageMeter()
        end = time.time()
        pending = []  # device-side metrics, read back only at print_freq
        steps = 0
        for i in itertools.count():
            with span("train.feed_wait"):
                item = next(batches, None)
            if item is None:
                break
            with span("train.upload"):
                images = item[0].to(self.device, non_blocking=True)
                labels = item[1].to(self.device, non_blocking=True)
            metrics = self.step_fn(images, labels, generator)
            pending.append((i, labels.shape[-1], metrics))
            steps += 1
            batch_time.update(time.time() - end)
            end = time.time()
            if (i + 1) % self.print_freq == 0:
                with span("train.drain"):
                    self._drain(epoch, pending, losses, precs)
                print(
                    f"Epoch: [{epoch}][{i + 1}]\t"
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                    f"Loss {losses.val:.3f} ({losses.avg:.3f})\t"
                    f"Prec {precs.val:.2%} ({precs.avg:.2%})"
                )
        if pending:
            with span("train.drain"):
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
