"""Share of the traced extract slice in which no operation ran on the device
(100 - the union of its device events' time over the slice's wall time)."""

from benchmark.metrics._shares import idle_pct


def read(info: dict):
    return idle_pct(info)
