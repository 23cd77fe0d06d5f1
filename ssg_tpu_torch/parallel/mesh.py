"""The port's mesh: one process per rank over a ``torch.distributed`` group.

Counterpart of ``ssg_tpu/parallel/mesh.py``. JAX's 1-D device mesh is one
controller driving every device; in PyTorch each rank is its own process,
so a ``Mesh`` is the process group with this process's place in it: its
rank, the group's size, the rank's device and the backend's name. A mesh
of one (no process group, or a group of one) runs every sharded function
in its one-device form.

The device is ``cuda:{LOCAL_RANK % device_count}`` unless the caller asks
for the CPU, as every other entry point of the port. The backend is the
one the caller names, by default ``nccl`` on the card and ``gloo`` on the
CPU; nothing switches backend or device when something fails. NCCL refuses
two ranks on one device, so ``make_mesh`` raises, naming the duplicate,
before a collective can fail; several ranks on one card are a gloo
configuration, asked for by name.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from ssg_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks; this process is ``rank`` on ``device``.

    ``group`` is the process group (None for a mesh of one without one).
    """

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where it names an index or the CPU,
    else ``cuda:{LOCAL_RANK % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    return dev


def _launched() -> bool:
    """torchrun (or a caller) set the environment of a group of more than one."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def check_distinct_devices(keys: list[str]) -> None:
    """Raise if two ranks name the same device (``host/uuid`` keys, one a
    rank): NCCL cannot put two ranks on one device."""
    seen: dict[str, int] = {}
    for rank, key in enumerate(keys):
        if key in seen:
            raise RuntimeError(
                f"nccl: ranks {seen[key]} and {rank} share the device {key}; NCCL takes one "
                f"rank a device (ask for backend='gloo' to run several ranks on one card)")
        seen[key] = rank


def _device_key(dev: torch.device) -> str:
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"


def _check_nccl_devices(dev: torch.device, rank: int, size: int) -> None:
    """Exchange device keys through the group's store (no NCCL call), then
    ``check_distinct_devices``."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"ssg_mesh_device/{rank}", _device_key(dev))
    check_distinct_devices([store.get(f"ssg_mesh_device/{r}").decode() for r in range(size)])


def make_mesh(n_devices: int | None = None, device=None, backend: str | None = None) -> Mesh:
    """The mesh over the default process group.

    Without one, a group launched by torchrun (``WORLD_SIZE`` > 1) is
    joined (``multihost.initialize``); otherwise the mesh is of one.
    ``n_devices`` must be the group's size where given (JAX's first-n
    devices have no counterpart when each rank is a process). ``backend``,
    where given, must be the group's.
    """
    from ssg_tpu_torch.parallel import multihost

    dev = rank_device(device)
    if not dist.is_initialized() and _launched():
        multihost.initialize(backend=backend, device=dev)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): no process group; launch {n_devices} "
                             "ranks (torchrun, or multihost.initialize in each)")
        return Mesh(None, 0, 1, dev, backend)
    size, rank = dist.get_world_size(), dist.get_rank()
    got = dist.get_backend()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has {size} ranks")
    if backend is not None and backend != got:
        raise ValueError(f"make_mesh(backend={backend!r}): the process group runs {got!r}")
    if got == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl needs a CUDA device; ask for backend='gloo' on the CPU")
        torch.cuda.set_device(dev)
        if size > 1:
            _check_nccl_devices(dev, rank, size)
    return Mesh(dist.group.WORLD, rank, size, dev, got)
