"""Joining the process group, and a host array's share on a rank.

Counterpart of ``ssg_tpu/parallel/multihost.py``. JAX's multi-controller
runtime becomes ``torch.distributed``'s process group: ``initialize``
joins it (idempotent), either from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
an explicit coordinator ``host:port``, process count and id. Every rank
computes the same host batch, so ``global_put`` is a slice: the rank's
contiguous row stripe of an array that every rank holds alike.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# How long a collective may wait for a rank before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, device=None,
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the default process group; a no-op when it is joined already.

    With no ``coordinator`` the group is torchrun's (``env://``). Else
    ``coordinator`` is ``host:port`` of rank 0's store, with
    ``num_processes`` ranks of which this is ``process_id``. ``backend``
    defaults to ``nccl`` for a CUDA ``device`` (the default) and ``gloo``
    for the CPU.
    """
    from ssg_tpu_torch.parallel.mesh import default_backend, rank_device

    if dist.is_initialized():
        return
    if backend is None:
        backend = default_backend(rank_device(device))
    if coordinator is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError(f"multihost.initialize: no coordinator and no {missing} in the "
                             "environment (launch with torchrun, or pass --dist_coordinator, "
                             "--dist_num_processes and --dist_process_id)")
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("multihost.initialize: a coordinator needs num_processes and "
                         "process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)


def is_multiprocess(mesh) -> bool:
    """True when ``mesh`` spans more than one rank."""
    return mesh.size > 1


def global_put(mesh, arr) -> torch.Tensor:
    """This rank's contiguous share of ``arr``'s leading axis (every rank
    holds ``arr`` alike), on the rank's device. The axis must divide by the
    mesh's size, as JAX's sharding requires."""
    x = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"global_put: {n} rows do not divide over {mesh.size} ranks")
    r = n // mesh.size
    return x[mesh.rank * r:(mesh.rank + 1) * r].to(mesh.device)
