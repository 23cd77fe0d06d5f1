"""Host ms a train step spent reading the losses back (every
``print_freq`` steps and at the epoch's end, each a wait for the device):
the program's ``train.drain`` spans of the traced epoch, summed, over its
``train.step`` spans. Silent where the program records no spans."""


def read(info: dict):
    try:
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without spans
        return None
    rec = recorded()
    steps = len(rec.of("train.step")) if rec is not None else 0
    return rec.host_ms("train.drain") / steps if steps else None
