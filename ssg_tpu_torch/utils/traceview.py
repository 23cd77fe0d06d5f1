"""Device-time aggregation for ``utils.profiling.trace`` captures.

Counterpart of ``ssg_tpu/utils/traceview.py`` over the torch profiler's
Chrome trace. The JAX package reads XLA's "XLA Modules" and "XLA Ops"
device lanes, whose ops carry their ``named_scope`` path; the torch trace
has no such lanes or paths. Here the device's leaf events (``cat`` of
``kernel``, ``gpu_memcpy``, ``gpu_memset``) carry no nesting, so straight
sums are exact, and each is attributed to a scope through its launch: the
runtime call with the same ``correlation`` id sits on a host thread inside
``torch.profiler.record_function`` ranges (``user_annotation``) and the
port's own spans (``utils.profiling.span``: dotted names such as
``cluster.rerank``, which some torch versions write as ``cpu_op``), and the
outermost range whose name ``scope_re`` matches names the scope.
``idle_by_span`` names the device's idle gaps by the innermost span the
host was in.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# The port's span names (``utils.profiling.span``).
SPAN_PATTERN = r"^[a-z][a-z0-9_]*\.[a-z0-9_]+$"
SPAN_RE = re.compile(SPAN_PATTERN)


def load_latest(logdir: str) -> dict | None:
    paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
    paths += glob.glob(f"{logdir}/**/*.trace.json", recursive=True)
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)


def _is_range(e) -> bool:
    """A ``record_function`` range or one of the port's spans."""
    cat = e.get("cat")
    return cat == "user_annotation" or (cat == "cpu_op" and SPAN_RE.match(e["name"]) is not None)


def _scopes(events, pat) -> dict:
    """(pid, tid) -> (sorted starts, [(start, end, name)]) of the matching
    ranges, outermost first where they share a start."""
    by_thread: dict = {}
    for e in events:
        if _is_range(e) and pat.search(e["name"]):
            by_thread.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], pat.search(e["name"]).group(0)))
    out = {}
    for key, spans in by_thread.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        out[key] = ([s[0] for s in spans], spans)
    return out


def _launches(events) -> dict:
    """correlation id -> the runtime call that launched it."""
    out = {}
    for e in events:
        if e.get("cat") in RUNTIME_CATS and "correlation" in (e.get("args") or {}):
            out[e["args"]["correlation"]] = e
    return out


def _scope_of(launch, scopes) -> str:
    if launch is None:
        return "(other)"
    starts, spans = scopes.get((launch["pid"], launch["tid"]), ([], []))
    for start, end, name in spans[:bisect.bisect_right(starts, launch["ts"])]:
        if start <= launch["ts"] <= end:  # outermost: the earliest start that holds it
            return name
    return "(other)"


def report_by_scope(logdir: str, scope_re: str = SPAN_PATTERN,
                    top_ops: int = 20, divisor: int = 1) -> dict | None:
    """Print device time grouped by the ``record_function`` range or port
    span matched with ``scope_re`` (by default the port's span names, so
    ``train.step`` or ``cluster.rerank``), and the top kernels; return both as
    ``{"total_us", "device_events", "by_scope": {scope: us},
    "by_op": {(scope, name): us}}`` (per call; ``device_events`` in all), or
    None when ``logdir`` holds no trace.

    ``divisor``: number of repetitions in the traced region (per-call
    figures are printed when > 1).
    """
    trace = load_latest(logdir)
    if trace is None:
        print("no trace json found")
        return None
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("dur")]
    if not device:
        print("no device events in trace")
    launches = _launches(events)
    pat = re.compile(scope_re)
    scopes = _scopes(events, pat)
    by_scope, by_op, total = {}, {}, 0.0
    for e in device:
        phase = _scope_of(launches.get((e.get("args") or {}).get("correlation")), scopes)
        by_scope[phase] = by_scope.get(phase, 0.0) + e["dur"]
        key = (phase, e["name"])
        by_op[key] = by_op.get(key, 0.0) + e["dur"]
        total += e["dur"]
    print(f"leaf device op sum {total / divisor / 1e6:.6f} s per call "
          f"({len(device)} device events)")
    for phase, dur in sorted(by_scope.items(), key=lambda kv: -kv[1]):
        print(f"{dur / divisor / 1e3:10.3f} ms  {phase}")
    print("---- top ops ----")
    for (phase, op), dur in sorted(by_op.items(), key=lambda kv: -kv[1])[:top_ops]:
        print(f"{dur / divisor / 1e3:10.3f} ms  {phase:16s} {op[:100]}")
    return {"total_us": total / divisor, "device_events": len(device),
            "by_scope": {k: v / divisor for k, v in by_scope.items()},
            "by_op": {k: v / divisor for k, v in by_op.items()}}


def _trace_spans(trace: dict, spans) -> dict:
    """tid -> [(start_us, end_us, name)] of the port's spans, sorted by
    start (outermost first where they share one), on the trace's clock:
    ``spans`` (``profiling.Span`` records) where given, else the trace's own
    ranges of the port's names."""
    if spans is None:
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        rows = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if _is_range(e) and SPAN_RE.match(e["name"])]
        if not rows:
            raise ValueError("the trace holds no port spans (a trace of CUDA activity only): "
                             "pass spans=profiling.recorded().spans")
    else:
        base = trace.get("baseTimeNanoseconds", 0)
        rows = [(s.tid, (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3, s.name)
                for s in spans]
    by_thread: dict = {}
    for tid, start, end, name in rows:
        by_thread.setdefault(tid, []).append((start, end, name))
    for lst in by_thread.values():
        lst.sort(key=lambda s: (s[0], -s[1]))
    return by_thread


def _innermost(spans: list, mids: list) -> list:
    """For each of the increasing ``mids``, the innermost of one thread's
    nested ``spans`` (sorted by start) that holds it, or None."""
    out, stack, i = [], [], 0
    for mid in mids:
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_by_span(trace, spans=None) -> dict:
    """Seconds of the device's idle gaps by the innermost port span that
    held each gap's midpoint on the host thread that launched the work
    ending the gap. Where that thread was in no span (the autograd engine
    launches a backward pass from a thread of its own while the caller
    waits in its span), the innermost span then open on another thread that
    launches device work names it; where none was, the CUDA runtime call
    (any thread) that spans the midpoint, else ``(outside spans)``. The
    gaps are those between the union of the device events' intervals.

    ``trace``: a loaded Chrome trace (``load_latest``) or a log dir.
    ``spans``: ``profiling.Span`` records (``recorded().spans``) to name
    the gaps by, placed on the trace's clock by its ``baseTimeNanoseconds``;
    by default the trace's own ranges of the port's span names, and a
    ValueError where it holds none (a trace of CUDA activity only).
    Returns {name: seconds}, the largest first."""
    if isinstance(trace, str):
        trace = load_latest(trace) or {}
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS and e.get("dur")),
                    key=lambda e: e["ts"])
    launches = _launches(events)
    launching = set()  # threads that launch device work
    gaps, cur_e = [], None  # (start, end, launching tid or None)
    for e in device:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        tid = None if launch is None else launch["tid"]
        launching.add(tid)
        s, f = e["ts"], e["ts"] + e["dur"]
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s, tid))
        cur_e = f if cur_e is None else max(cur_e, f)
    mids = [0.5 * (a + b) for a, b, _ in gaps]
    held = {tid: _innermost(lst, mids)  # tid -> the innermost span at each gap
            for tid, lst in _trace_spans(trace, spans).items() if tid in launching}
    runtime = sorted((e for e in events if e.get("cat") in RUNTIME_CATS and e.get("dur")),
                     key=lambda e: e["ts"])
    starts = [e["ts"] for e in runtime]
    out: dict = {}
    for k, (a, b, tid) in enumerate(gaps):
        own = held.get(tid, [None] * len(gaps))[k]
        other = [h[k] for t, h in held.items() if t != tid and h[k] is not None]
        span = own or max(other, default=None)  # the latest start: the innermost
        if span is not None:
            name = span[2]
        else:
            name = "(outside spans)"
            i = bisect.bisect_right(starts, mids[k])
            for e in reversed(runtime[max(0, i - 64):i]):  # the latest start that spans it
                if e["ts"] + e["dur"] >= mids[k]:
                    name = e["name"]
                    break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
