"""The train step's share of the bf16 dense peak while the device works:
three forwards' operations of every step of the traced epoch
(``frozen/flops.py``) over its device-busy seconds, against 989 TFLOP/s."""

from benchmark.frozen.peaks import BF16_FLOP_PER_S
from benchmark.metrics._shares import mfu


def read(info: dict):
    return mfu(info, BF16_FLOP_PER_S)
