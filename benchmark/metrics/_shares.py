"""Arithmetic the per-layer readers share. ``info`` holds the reduced trace
of the traced slice (``trace``: ``window_s``, ``busy_s``,
``device_events``, ``by_name``) and the cell's counts for that slice and
its check (``counts``). The traced slice is one whole unit of the window:
a train epoch, an extract pass, a clustering pass. Tracing costs the host
time a launch, so a host-bound slice runs slower than the window and
reads more idle; the device's busy time is not changed by it."""

from __future__ import annotations


def idle_pct(info: dict) -> float | None:
    t = info["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(info: dict, peak: float) -> float | None:
    """The traced slice's counted operations over the seconds in which the
    device was busy, as a share of ``peak``: how well the device uses the
    time it works, whatever the host's pace (which ``idle_pct`` reads).
    Together: a rate = mfu x peak x (1 - idle) / operations a unit."""
    t, flops = info["trace"], info["counts"].get("flops")
    if t is None or not flops or t["busy_s"] <= 0:
        return None
    return 100.0 * flops / t["busy_s"] / peak
