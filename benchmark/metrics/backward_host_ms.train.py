"""Host ms a train step spent in ``zero_grad`` and the backward pass (and
the data-parallel all-reduce): the program's ``train.backward`` spans of
the traced epoch over its ``train.step`` spans. Silent where the program
records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    steps = len(rec.of("train.step")) if rec is not None else 0
    return rec.host_ms("train.backward") / steps if steps else None
