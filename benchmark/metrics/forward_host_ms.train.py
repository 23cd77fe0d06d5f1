"""Host ms a train step spent launching the forward (crop, flip,
normalise, the model, the losses): the program's ``train.forward`` spans
of the traced epoch over its ``train.step`` spans. Silent where the
program records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    steps = len(rec.of("train.step")) if rec is not None else 0
    return rec.host_ms("train.forward") / steps if steps else None
