"""Profiling and timing harness.

Counterpart of ``ssg_tpu/utils/profiling.py`` (the reference has no
profiler, SURVEY.md §5 tracing row): ``trace`` wraps ``torch.profiler``
(CPU and, where there is a card, CUDA activity; a gzipped Chrome trace in
``logdir`` that ``utils.traceview`` and Perfetto read), ``wallclock`` times
a call with the card synchronised, and ``device_memory_stats`` snapshots
the card's memory under the JAX package's three keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from ssg_tpu_torch._device import resolve_device


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block into
    ``logdir/trace-<ns>.pt.trace.json.gz``.

    Usage::
        with profiling.trace('logs/ssg-trace'):
            api.extract_features(model, batches)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{time.time_ns()}.pt.trace.json.gz"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def wallclock(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 1,
    **kwargs,
) -> dict:
    """Time ``fn(*args, **kwargs)`` on the host clock, the card
    synchronised after every call.

    Runs ``warmup`` untimed calls (kernel builds, cuDNN plans), then
    ``iters`` timed calls. Returns stats in seconds.
    """
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_s": sum(times) / len(times),
        "min_s": times[0],
        "p50_s": times[len(times) // 2],
        "max_s": times[-1],
        "iters": iters,
    }


def device_memory_stats(device=None) -> dict:
    """The card's memory in bytes: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (PyTorch's allocator), ``bytes_limit`` (the
    card's total). ``{}`` for the CPU, which keeps no such statistics."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
