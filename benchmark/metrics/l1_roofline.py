"""The L1 Jaccard kernel's share of its roofline: the least time the work
these inputs need could take (``frozen/l1work.py``, from the reference's V
of each group) over the time of the device events named ``l1_kernel`` in
the traced pass. Silent where the pass ran no such kernel."""

from benchmark.frozen import l1work


def read(info: dict):
    t, counts = info["trace"], info["counts"]
    secs = sum(v for k, v in t["by_name"].items() if "l1_kernel" in k)
    cols = counts.get("l1_col_counts")
    if secs <= 0 or not cols:
        return None
    passes = counts.get("passes", 1)
    bound = passes * sum(l1work.bound_s(c.tolist(), len(c)) for c in cols)
    return 100.0 * bound / secs
