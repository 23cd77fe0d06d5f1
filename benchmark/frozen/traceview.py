"""Reduction of a ``torch.profiler`` Chrome trace of the traced slice to its
device time.

The trace arithmetic is copied from ``ssg_tpu_torch/utils/traceview.py`` at
commit 78531ab: device leaf events are those of ``cat`` ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; they carry no nesting, so sums over
them are exact. Added here: the device's busy time is the union of the
device events' intervals, and each idle gap between them is named by the
CUDA runtime call (``cuda_runtime``, ``cuda_driver``) on the host that
spans the gap's middle, or ``(host between calls)`` where none does. The
slice's wall time is measured on the host clock around it; what it holds
beyond the device events' span is idle as well. The busy time is not
capped at the wall time: a busy time over it shows a window or clock
that does not line up with the device's, as an impossible idle share.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(host before the first or after the last device event)"


def load(path: str) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def reduce_slice(events: list[dict], window_s: float, top: int = 10) -> dict | None:
    """The slice's ``window_s`` (given), ``busy_s``, ``device_events``,
    ``by_name`` {kernel or copy name: seconds} and the
    ``breakdown`` lists (``device_ops``, ``idle_gaps``: at most ``top`` each,
    ``[name, seconds]``). None when the trace holds no device event."""
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS and e.get("dur")),
                    key=lambda e: e["ts"])
    if not device:
        return None
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for e in device:
        s, f = e["ts"], e["ts"] + e["dur"]
        if cur_e is not None and s <= cur_e:
            cur_e = max(cur_e, f)
            continue
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
        cur_s, cur_e = s, f
    busy += cur_e - cur_s
    runtime = sorted((e for e in events if e.get("cat") in RUNTIME_CATS and e.get("dur")),
                     key=lambda e: e["ts"])
    starts = [e["ts"] for e in runtime]
    by_gap: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "(host between calls)"
        i = bisect.bisect_right(starts, mid)
        for e in reversed(runtime[max(0, i - 64):i]):  # the latest start that spans it
            if e["ts"] + e["dur"] >= mid:
                name = e["name"]
                break
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) * 1e-6
    outside = window_s - (cur_e - device[0]["ts"]) * 1e-6
    if outside > 0:
        by_gap[OUTSIDE] = outside
    return {
        "window_s": window_s,
        "busy_s": busy * 1e-6,
        "device_events": len(device),
        "by_name": by_name,
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
