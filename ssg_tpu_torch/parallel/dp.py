"""Data-parallel placement: a rank's share of a batch, and one copy of the
weights everywhere.

Counterpart of ``ssg_tpu/parallel/dp.py``. There sharding annotations
place the batch over the mesh and replicate the parameters, and XLA inserts
the gradient all-reduce. Here each rank takes its contiguous slice of the
batch (``shard_batch``), rank 0's parameters and buffers are broadcast
once (``replicate``), and the train step sums the gradients over the ranks
(``all_reduce_grads``, ``train/trainer.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_batch(mesh, x):
    """This rank's contiguous slice of ``x``'s leading axis (a tensor or a
    numpy array, kept on its device; the batch must divide by the size)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_batch: a batch of {n} does not divide over {mesh.size} ranks")
    r = n // mesh.size
    return x[mesh.rank * r:(mesh.rank + 1) * r]


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)
    return module


def all_reduce_grads(mesh, params) -> None:
    """Sum every parameter's gradient over the ranks, in place, as one
    flat buffer a dtype. A sum, not DDP's mean: each rank's gradient is its
    share of the one global loss's."""
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in {g.dtype for g in grads}:
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

