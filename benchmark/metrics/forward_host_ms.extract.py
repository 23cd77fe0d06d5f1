"""Host ms a batch of the extract (the test transform's, the eval
forward's and the gather's launches, and any wait among them): the
program's ``extract.batch`` spans of the traced pass, over their number.
Silent where the program records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    batches = len(rec.of("extract.batch")) if rec is not None else 0
    return rec.host_ms("extract.batch") / batches if batches else None
