"""The clustering pass's share of the chip's peaks: the least time the work its
inputs need could take, over the traced pass's device-busy seconds. The work
needed is each group's distance Gram (2 N^2 D operations at the fp32 FMA
peak, 67 TFLOP/s; the program computes it in fp32) and the L1 Jaccard's work
for that group's V (``frozen/l1work.py``). The re-ranking's dense neighbour-
count and query-expansion products are the program's dense way of doing
sparse work and are not counted, so the share reads the same whichever way a
later program does them. Silent without V's column counts."""

from benchmark.frozen import l1work
from benchmark.frozen.peaks import FP32_FMA_FLOP_PER_S


def read(info: dict):
    t, counts = info["trace"], info["counts"]
    cols, gram = counts.get("l1_col_counts"), counts.get("gram_flops")
    if t is None or t["busy_s"] <= 0 or not cols or not gram:
        return None
    passes = counts.get("passes", 1)
    need = passes * (gram / FP32_FMA_FLOP_PER_S
                     + sum(l1work.bound_s(c.tolist(), len(c)) for c in cols))
    return 100.0 * need / t["busy_s"]
