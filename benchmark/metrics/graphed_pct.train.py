"""Share of the traced epoch's train steps that replayed the program's CUDA
graphs, in %: its ``train.graph_replays`` counter over its ``train.step``
spans, x 100. Silent where the program has no such counter."""


def read(info: dict):
    try:
        from ssg_tpu_torch.train.trainer import GRAPH_REPLAYS
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without graphed steps or spans
        return None
    rec = recorded()
    steps = len(rec.of("train.step")) if rec is not None else 0
    return 100.0 * rec.counters.get(GRAPH_REPLAYS, 0) / steps if steps else None
