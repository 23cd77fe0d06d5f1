"""Attention's share of its roofline in the traced epoch, in %: the least
time its forwards and backwards could take (``frozen/vitwork.py``: the
larger of the operations over the bf16 peak and the bytes over the card's
bandwidth, a step, times the epoch's steps) over the time of the device
events the rule classes as attention. Silent where the epoch ran none."""

from benchmark.frozen.vitwork import attention_seconds


def read(info: dict):
    t, bound = info["trace"], info["counts"].get("attention_bound_s")
    secs = attention_seconds(t["by_name"]) if t is not None else 0.0
    if secs <= 0 or not bound:
        return None
    return 100.0 * bound / secs
