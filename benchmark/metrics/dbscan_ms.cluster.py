"""Stream ms a feature group from DBSCAN's first launch to its last (the
eps-graph, the closure's squarings, the labels): the CUDA events of the
program's ``cluster.dbscan`` spans in the traced pass, over their number.
Silent where the program records no spans or their events."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    groups = len(rec.of("cluster.dbscan")) if rec is not None else 0
    ms = rec.device_ms("cluster.dbscan") if groups else None
    return ms / groups if ms is not None else None
