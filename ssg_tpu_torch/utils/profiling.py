"""Profiling and timing harness, and the port's own spans and counters.

Counterpart of ``ssg_tpu/utils/profiling.py`` (the reference has no
profiler, SURVEY.md §5 tracing row): ``trace`` wraps ``torch.profiler``
(CPU and, where there is a card, CUDA activity; a gzipped Chrome trace in
``logdir`` that ``utils.traceview`` and Perfetto read), ``wallclock`` times
a call with the card synchronised, and ``device_memory_stats`` snapshots
the card's memory under the JAX package's three keys.

Spans and counters (the JAX package's ``named_scope`` per stage): the
train loop, the extract and the clustering open ``span(name, key)`` at
their layers' boundaries and ``count(name)`` their units. Both record only
while a ``torch.profiler`` session is active or inside ``record_spans()``;
otherwise a span is one flag check and a shared no-op context. A recorded
span keeps its name, parent, ``key`` (the step, group or batch index its
unit's spans share; a child without one takes its parent's), the native
thread id and its host start and end in CLOCK_REALTIME ns, the clock the
profiler trace's ``baseTimeNanoseconds + ts * 1000`` follows (within a few
us for its ranges over a session of a second or more; its CUDA runtime
events ran 57-73 us ahead on an H100 host). Under a profiler it
also opens a ``torch.profiler`` range of the same name, which a trace with
CPU activity holds beside the device events; with ``device=True`` it
records a CUDA event pair on the current stream, for the stream time from
the span's first launch to its last. ``recorded()`` returns the newest
session's spans and counters, the events resolved then; a session starts
with each profiler session and each ``record_spans()`` block. Nothing here
synchronises the device.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

from ssg_tpu_torch._device import resolve_device

# Spans a session keeps; later ones are counted in ``Recorded.dropped``.
MAX_SPANS = 1 << 18

_forced = 0  # open record_spans() blocks
_session = None  # the newest session (_Session)
_lock = threading.Lock()  # opens sessions
_local = threading.local()  # .stack: this thread's open spans; .tid
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span(NamedTuple):
    """One recorded span. ``id`` and ``parent`` (None at the top) number
    the session's spans in the order they opened; ``device_ms`` is the
    stream time between its CUDA events (None without them, or where the
    stream has not reached the second yet)."""

    name: str
    id: int
    parent: int | None
    key: object
    tid: int
    start_ns: int
    end_ns: int
    device_ms: float | None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Recorded(NamedTuple):
    """A session's closed spans (in the order they opened), its counters
    and the number of spans past ``MAX_SPANS`` it did not keep."""

    spans: list
    counters: dict
    dropped: int

    def of(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def host_ms(self, name: str) -> float:
        """Host ms summed over the spans named ``name``."""
        return sum(s.host_ms for s in self.spans if s.name == name)

    def device_ms(self, name: str) -> float | None:
        """Stream ms summed over the spans named ``name``; None where any
        of them has none."""
        times = [s.device_ms for s in self.spans if s.name == name]
        return None if not times or None in times else sum(times)


class _Session:
    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()  # the counters' updates
        self.dropped = 0
        self.ids = itertools.count()


def _current() -> _Session:
    global _session
    if _session is None:  # a profiler started before this module was loaded
        with _lock:
            if _session is None:
                _session = _Session()
    return _session


def _open() -> None:
    global _session
    _session = _Session()


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    """torch calls this as every profiler session starts (it sets
    ``_is_profiler_enabled``): that session's spans start a session of
    ours, unless a ``record_spans()`` block is open."""
    start()
    if not _forced:
        _open()


_autograd_profiler._run_on_profiler_start = _on_profiler_start


_OFF = contextlib.nullcontext()  # every span that does not record


class _Span:
    __slots__ = ("name", "key", "device", "session", "id", "parent", "tid", "start_ns",
                 "end_ns", "range", "events", "device_ms")

    def __init__(self, name, key, device):
        self.name, self.key, self.device = name, key, device

    def __enter__(self):
        self.session = s = _current()
        stack = getattr(_local, "stack", None)
        if stack is None:  # a thread's first span (its native id is a system call)
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        top = stack[-1] if stack and stack[-1].session is s else None
        self.parent = None if top is None else top.id
        if self.key is None and top is not None:
            self.key = top.key
        self.id = next(s.ids)
        self.tid = _local.tid
        stack.append(self)
        self.range = None
        if _RANGE is not None and _autograd_profiler._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        self.events, self.device_ms = None, None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        s = self.session
        if len(s.spans) < MAX_SPANS:
            s.spans.append(self)
        else:
            s.dropped += 1
        return False

    def resolve(self) -> Span:
        if self.events is not None and self.device_ms is None and self.events[1].query():
            self.device_ms = self.events[0].elapsed_time(self.events[1])
        return Span(self.name, self.id, self.parent, self.key, self.tid, self.start_ns,
                    self.end_ns, self.device_ms)


def span(name: str, key=None, device: bool = False):
    """A context manager that records the enclosed block as a span
    ``name`` (the module docstring) while a profiler session is active or
    inside ``record_spans()``, and otherwise does nothing.

    Usage::
        with profiling.span("cluster.eps", key=g, device=True):
            eps = select_eps(dist)
    """
    if not (_autograd_profiler._is_profiler_enabled or _forced):
        return _OFF
    return _Span(name, key, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans record."""
    if _autograd_profiler._is_profiler_enabled or _forced:
        s = _current()
        with s.lock:
            s.counters[name] = s.counters.get(name, 0) + n


@contextlib.contextmanager
def record_spans():
    """Record spans and counters in the enclosed block without a profiler:
    the host split of an unprofiled run, read with ``recorded()``."""
    global _forced
    if not _forced:
        _open()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def recorded() -> Recorded | None:
    """The spans and counters of the newest profiler session or
    ``record_spans()`` block (None before any), each starting afresh.
    Device times resolve from events the stream has passed: call it after
    synchronising."""
    s = _session
    if s is None:
        return None
    return Recorded([x.resolve() for x in sorted(s.spans, key=lambda x: x.id)],
                    dict(s.counters), s.dropped)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block into
    ``logdir/trace-<ns>.pt.trace.json.gz``. The port's spans of the block
    are in it, and in ``recorded()`` afterwards.

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
