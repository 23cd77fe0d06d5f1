"""Squaring rounds of DBSCAN's transitive closure a feature group: the
program's ``dbscan.closure_rounds`` counter in the traced pass over its
``cluster.dbscan`` spans. Each round is one N x N bf16 product and one
host check, so the count sets much of a group's DBSCAN time. Silent where
the program records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    groups = len(rec.of("cluster.dbscan")) if rec is not None else 0
    rounds = rec.counters.get("dbscan.closure_rounds") if groups else None
    return rounds / groups if rounds is not None else None
