"""Stream ms a feature group from the re-ranking's first launch to its
last (top-k, masks and 0/1 products, encoding, query expansion, the L1
Jaccard): the CUDA events of the program's ``cluster.rerank`` spans in the
traced pass, over their number. Silent where the program records no spans
or their events."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    groups = len(rec.of("cluster.rerank")) if rec is not None else 0
    ms = rec.device_ms("cluster.rerank") if groups else None
    return ms / groups if ms is not None else None
