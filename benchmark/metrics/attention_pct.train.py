"""Attention's share of the traced epoch's device-busy time, in %: the
device events that ``frozen/vitwork.py``'s rule classes as attention over
the epoch's busy seconds. Silent where the epoch ran no such event."""

from benchmark.frozen.vitwork import attention_seconds


def read(info: dict):
    t = info["trace"]
    secs = attention_seconds(t["by_name"]) if t is not None else 0.0
    if secs <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * secs / t["busy_s"]
