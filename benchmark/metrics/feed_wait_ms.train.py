"""Host ms a train step in which the trainer's thread waits for the next
host batch from the prefetch queue: the program's ``train.feed_wait``
spans of the traced epoch over its ``train.step`` spans. Silent where the
program records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    steps = len(rec.of("train.step")) if rec is not None else 0
    return rec.host_ms("train.feed_wait") / steps if steps else None
