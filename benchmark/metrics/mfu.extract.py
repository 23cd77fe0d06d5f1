"""The eval forward's share of the bf16 dense peak while the device works:
one forward's operations of every real image of the traced pass
(``frozen/flops.py``) over its device-busy seconds, against 989 TFLOP/s."""

from benchmark.frozen.peaks import BF16_FLOP_PER_S
from benchmark.metrics._shares import mfu


def read(info: dict):
    return mfu(info, BF16_FLOP_PER_S)
