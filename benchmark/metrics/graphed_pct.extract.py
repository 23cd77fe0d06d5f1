"""Share of the traced pass's extract batches that replayed the program's
CUDA graph of the eval forward, in %: its ``extract.graph_replays`` counter
over its ``extract.batch`` spans, x 100. Silent where the program has no
such counter."""


def read(info: dict):
    try:
        from ssg_tpu_torch.api import EXTRACT_GRAPH_REPLAYS
        from ssg_tpu_torch.utils.profiling import recorded
    except ImportError:  # a program without a graphed extract or spans
        return None
    rec = recorded()
    batches = len(rec.of("extract.batch")) if rec is not None else 0
    return 100.0 * rec.counters.get(EXTRACT_GRAPH_REPLAYS, 0) / batches if batches else None
