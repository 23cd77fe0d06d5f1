"""Device-time aggregation for ``utils.profiling.trace`` captures.

Counterpart of ``ssg_tpu/utils/traceview.py`` over the torch profiler's
Chrome trace. The JAX package reads XLA's "XLA Modules" and "XLA Ops"
device lanes, whose ops carry their ``named_scope`` path; the torch trace
has no such lanes or paths. Here the device's leaf events (``cat`` of
``kernel``, ``gpu_memcpy``, ``gpu_memset``) carry no nesting, so straight
sums are exact, and each is attributed to a scope through its launch: the
runtime call with the same ``correlation`` id sits on a host thread inside
``torch.profiler.record_function`` ranges (``user_annotation``), and the
outermost range whose name ``scope_re`` matches names the scope.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_latest(logdir: str) -> dict | None:
    paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
    paths += glob.glob(f"{logdir}/**/*.trace.json", recursive=True)
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)


def _scopes(events, pat) -> dict:
    """(pid, tid) -> (sorted starts, [(start, end, name)]) of the matching
    ``user_annotation`` ranges, outermost first where they share a start."""
    by_thread: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and pat.search(e["name"]):
            by_thread.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], pat.search(e["name"]).group(0)))
    out = {}
    for key, spans in by_thread.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        out[key] = ([s[0] for s in spans], spans)
    return out


def _scope_of(launch, scopes) -> str:
    if launch is None:
        return "(other)"
    starts, spans = scopes.get((launch["pid"], launch["tid"]), ([], []))
    for start, end, name in spans[:bisect.bisect_right(starts, launch["ts"])]:
        if start <= launch["ts"] <= end:  # outermost: the earliest start that holds it
            return name
    return "(other)"


def report_by_scope(logdir: str, scope_re: str = r"[a-z]+_\w+",
                    top_ops: int = 20, divisor: int = 1) -> dict | None:
    """Print device time grouped by the ``record_function`` scope matched
    with ``scope_re``, and the top kernels; return both as
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
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in (e.get("args")
                                                                                 or {}):
            launches[e["args"]["correlation"]] = e
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
