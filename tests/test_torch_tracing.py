"""The port's spans and counters (``utils.profiling.span``, ``count``,
``record_spans``, ``recorded``) and ``utils.traceview.idle_by_span`` on the
CPU: a span that is off costs nothing, one that is on lines up with its
range in the profiler's trace, the train loop, the clustering and the
extract record their layers' spans, and spans change no result. The last
test needs a card: the CUDA events of ``device=True`` spans."""

import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from ssg_tpu_torch import api, models
from ssg_tpu_torch.train.schedule import make_optimizer
from ssg_tpu_torch.train.trainer import Trainer, make_train_step
from ssg_tpu_torch.utils import profiling, traceview


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_a_span_that_is_off_records_nothing_and_allocates_nothing():
    with profiling.record_spans():
        pass
    assert profiling.recorded() == ([], {}, 0)

    def spans():
        for i in range(200):
            with profiling.span("train.step", key=i, device=True):
                with profiling.span("train.forward"):
                    profiling.count("dbscan.closure_rounds")

    spans()  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = after.filter_traces([tracemalloc.Filter(True, profiling.__file__)])
    grown = here.compare_to(before.filter_traces([tracemalloc.Filter(True, profiling.__file__)]),
                            "filename")
    assert sum(d.size_diff for d in grown) == 0 and sum(d.count_diff for d in grown) == 0
    assert profiling.span("a.b") is profiling.span("c.d", key=1, device=True)
    assert profiling.recorded() == ([], {}, 0)


def test_spans_line_up_with_the_profiler_trace(tmp_path):
    with _cpu_profile() as prof:
        with profiling.span("warm.up"):  # the first ranges pay a one-off set-up
            with profiling.span("warm.inner"):
                torch.ones(64).sum()
        for k in range(10):
            with profiling.span("cluster.rerank", key=k):
                with profiling.span("rerank.topk"):
                    torch.ones(64).sum()
                with profiling.span("rerank.l1", key=99):
                    torch.ones(64).sum()
        profiling.count("dbscan.closure_rounds", 3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    rec = profiling.recorded()
    assert rec.counters == {"dbscan.closure_rounds": 3} and rec.dropped == 0
    base = trace["baseTimeNanoseconds"]
    ranges = [e for e in trace["traceEvents"] if e.get("ph") == "X" and traceview._is_range(e)
              and traceview.SPAN_RE.match(e["name"])]
    assert [e["name"] for e in ranges] == [s.name for s in rec.spans]
    for s, e in zip(rec.spans, ranges):
        assert s.tid == e["tid"] == threading.get_native_id()
        if s.name.startswith("warm."):
            continue
        assert abs(s.start_ns - (base + round(e["ts"] * 1000))) <= 2000, s
        assert abs(s.end_ns - (base + round((e["ts"] + e["dur"]) * 1000))) <= 2000, s
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith("rerank."):
            parent = by_id[s.parent]
            assert parent.name == "cluster.rerank"
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.key == (99 if s.name == "rerank.l1" else parent.key)
        elif s.name != "warm.inner":
            assert s.parent is None
    assert [s.key for s in rec.of("cluster.rerank")] == list(range(10))
    # A later session starts afresh.
    with _cpu_profile():
        with profiling.span("extract.gather"):
            pass
    assert [s.name for s in profiling.recorded().spans] == ["extract.gather"]


def test_each_profiler_session_starts_afresh():
    """Back-to-back profiler sessions with no ``recorded()`` between them
    keep apart, and one that records nothing reads empty."""
    for name in ("cluster.eps", "cluster.dbscan"):
        with _cpu_profile():
            with profiling.span(name):
                profiling.count("dbscan.closure_rounds", 2)
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["cluster.dbscan"]
    assert rec.counters == {"dbscan.closure_rounds": 2}
    with _cpu_profile():
        pass
    assert profiling.recorded() == ([], {}, 0)
    # A profiler started inside a record_spans() block does not split it.
    with profiling.record_spans():
        with profiling.span("extract.batch"):
            pass
        with _cpu_profile():
            with profiling.span("extract.gather"):
                pass
    assert [s.name for s in profiling.recorded().spans] == ["extract.batch", "extract.gather"]


def test_spans_and_counts_from_many_threads_lose_nothing():
    threads, per = 8, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.record_spans():
            def work(t):
                for i in range(per):
                    with profiling.span("feed.host", key=t):
                        with profiling.span("feed.inner"):
                            profiling.count("thread.units")

            pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
    rec = profiling.recorded()
    assert rec.counters == {"thread.units": threads * per}
    assert len(rec.spans) == 2 * threads * per
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.of("feed.inner"):  # each child's parent is its own thread's span
        parent = by_id[s.parent]
        assert parent.name == "feed.host" and parent.tid == s.tid and parent.key == s.key


def _tiny_model():
    model = models.create("resnet50", stage_sizes=(1, 1), num_features=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _train(batches, record: bool):
    model = _tiny_model()
    opt = make_optimizer(model.parameters(), 1e-3)
    step = make_train_step(model, opt, num_parts=3, height=32, width=16)
    trainer = Trainer(step, opt, print_freq=2, device="cpu")
    losses = []

    def stepper(images, labels, generator):
        out = step(images, labels, generator)
        losses.append(out["loss"])
        return out

    trainer.step_fn = stepper
    with profiling.record_spans() if record else profiling.span("off.path"):
        out = trainer.train(0, iter(batches), torch.Generator().manual_seed(1))
    return out, torch.stack(losses)


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [((rng.random((8, 32, 16, 3)) * 255).astype(np.uint8),
             np.tile(np.repeat(np.arange(2), 4)[None], (3, 1)) + b) for b in range(n)]


def test_trainer_records_the_step_spans():
    out, _ = _train(_batches(), record=True)
    assert out["steps"] == 3
    rec = profiling.recorded()
    main = threading.get_native_id()
    on_main = [(s.name, s.key) for s in rec.spans if s.tid == main]
    step = ["train.step", "train.forward", "train.backward", "train.optimizer"]
    expect = []
    for k in range(3):  # the step's spans keyed by the step function's calls
        expect += [("train.feed_wait", None), ("train.upload", None)] + [(n, k) for n in step]
        if k == 1:
            expect.append(("train.drain", None))  # print_freq 2
    expect += [("train.feed_wait", None), ("train.drain", None)]  # the end, the last drain
    assert on_main == expect
    feed = rec.of("feed.host")
    assert len(feed) == 4 and main not in {s.tid for s in feed}  # 3 batches, then the end
    assert rec.counters == {}
    by_id = {s.id: s for s in rec.spans}
    for s in rec.of("train.forward") + rec.of("train.backward") + rec.of("train.optimizer"):
        assert by_id[s.parent].name == "train.step" and by_id[s.parent].key == s.key


def _features(groups=3, n=150, dim=16, ids=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    centres = torch.randn((groups, ids, dim), generator=g)
    assign = torch.randint(0, ids, (n,), generator=g)
    f = centres[:, assign] + 0.25 * torch.randn((groups, n, dim), generator=g)
    return f / f.norm(dim=2, keepdim=True)


ANALYTICS = dict(k1=8, k2=3, rho=0.03, min_samples=2, device="cpu")


def test_cluster_groups_records_the_stage_spans_and_closure_rounds(monkeypatch):
    feats = _features()
    rounds = [0]
    equal = torch.equal

    def counting(a, b):
        rounds[0] += 1
        return equal(a, b)

    monkeypatch.setattr(torch, "equal", counting)
    with profiling.record_spans():
        labels, counts, _ = api.cluster_groups(feats, **ANALYTICS)
    rec = profiling.recorded()
    assert rounds[0] >= 3 and rec.counters == {"dbscan.closure_rounds": rounds[0]}
    top = [(s.name, s.key) for s in rec.spans if s.parent is None]
    stages = ("cluster.dist", "cluster.rerank", "cluster.eps", "cluster.dbscan")
    assert top == [(n, g) for g in range(3) for n in stages] + [("cluster.readback", None)]
    by_id = {s.id: s for s in rec.spans}
    inner = [(s.name, s.key) for s in rec.spans if s.parent is not None]
    assert inner == [(n, g) for g in range(3) for n in
                     ("rerank.topk", "rerank.expand", "rerank.encode", "rerank.qe", "rerank.l1")]
    assert all(by_id[s.parent].name == "cluster.rerank" for s in rec.spans if s.parent is not None)
    if not torch.cuda.is_initialized():  # no card: no events
        assert all(s.device_ms is None for s in rec.spans)
        assert rec.device_ms("cluster.dbscan") is None
    assert rec.host_ms("cluster.dbscan") > 0
    assert min(counts) >= 2 and labels.shape == (3, 150)


def _extract(model, batches, record: bool):
    with profiling.record_spans() if record else profiling.span("off.path"):
        feats, _, _, _ = api.extract_features(model, batches, device="cpu")
    return feats


def _extract_batches():
    rng = np.random.default_rng(1)
    out = []
    for b in range(3):
        images = (rng.random((4, 64, 32, 3)) * 255).astype(np.uint8)
        mask = np.ones(4, bool) if b < 2 else np.array([1, 1, 0, 0], bool)
        out.append((images, np.arange(4) + 4 * b, np.zeros(4, int), mask))
    return out


def test_extract_records_a_span_a_batch():
    feats = _extract(_tiny_model(), _extract_batches(), record=True)
    rec = profiling.recorded()
    assert [(s.name, s.key) for s in rec.spans] == [("extract.batch", b) for b in range(3)] + [
        ("extract.gather", None)]
    assert rec.counters == {}
    assert feats.shape[1] == 10


def test_spans_change_no_result():
    batches = _batches()
    (off, loss_off), (on, loss_on) = _train(batches, False), _train(batches, True)
    assert torch.equal(loss_off, loss_on) and off == on
    feats = _features(seed=3)
    a = api.cluster_groups(feats, **ANALYTICS)
    with profiling.record_spans():
        b = api.cluster_groups(feats, **ANALYTICS)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    model = _tiny_model()
    assert torch.equal(_extract(model, _extract_batches(), False),
                       _extract(model, _extract_batches(), True))


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _kernel(ts, dur, correlation):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": correlation}}


def _idle_trace():
    """Device busy [0, 10), [30, 40), [60, 70), [100, 110), [150, 160),
    [180, 190); the events after the gaps launched by threads 1, 2, 1, 1
    and 3 (3 holds no span, as the autograd engine's thread)."""
    return {"baseTimeNanoseconds": 1_000_000, "traceEvents": [
        _x("user_annotation", "train.step", 0, 90),
        _x("cpu_op", "train.backward", 15, 30),
        _x("user_annotation", "Optimizer.step#AdamW.step", 40, 20),  # not a port span
        _x("user_annotation", "train.step", 160, 40),
        _x("user_annotation", "train.backward", 165, 30),
        _x("user_annotation", "feed.host", 0, 120, tid=2),
        _x("user_annotation", "feed.host", 125, 100, tid=4),  # launches nothing
        _x("cuda_runtime", "cudaLaunchKernel", 0, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=2, correlation=3),
        _x("cuda_runtime", "cudaStreamSynchronize", 70, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 140, 1, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 170, 1, tid=3, correlation=6),
        _kernel(0, 10, 1), _kernel(30, 10, 2), _kernel(60, 10, 3), _kernel(100, 10, 4),
        _kernel(150, 10, 5), _kernel(180, 10, 6),
    ]}


def test_idle_by_span_on_a_hand_written_trace(tmp_path):
    """Gap [10, 30), midpoint 20: ``train.backward`` (inside
    ``train.step``) on thread 1, which launched the next event; [40, 60),
    50: ``feed.host`` on thread 2, which launched it (thread 1 was in
    ``train.step``); [70, 100), 85: ``train.step``; [110, 150), 130: no
    span of a launching thread (thread 4's ``feed.host`` launches nothing)
    and no runtime call (the synchronise ended at 110); [160, 180), 170:
    thread 3 holds no span, so thread 1's ``train.backward`` names it."""
    trace = _idle_trace()
    got = traceview.idle_by_span(trace)
    assert got == pytest.approx({"train.backward": 40e-6, "train.step": 30e-6,
                                 "feed.host": 20e-6, "(outside spans)": 40e-6})
    assert list(got)[0] in ("train.backward", "(outside spans)")
    # A runtime call that spans a gap's midpoint names it where no span does.
    trace["traceEvents"].append(_x("cuda_runtime", "cudaMemcpyAsync", 120, 20, tid=4))
    assert traceview.idle_by_span(trace)["cudaMemcpyAsync"] == pytest.approx(40e-6)
    # Spans given as records (a CUDA-only trace has no ranges) on the
    # shared clock: baseTimeNanoseconds + ts * 1000; without them such a
    # trace has nothing to name its gaps by.
    bare = {"baseTimeNanoseconds": 1_000_000,
            "traceEvents": [e for e in _idle_trace()["traceEvents"]
                            if not traceview._is_range(e)]}
    with pytest.raises(ValueError, match="no port spans"):
        traceview.idle_by_span(bare)
    spans = [profiling.Span("train.step", 0, None, 0, 1, 1_000_000, 1_090_000, None),
             profiling.Span("train.backward", 1, 0, 0, 1, 1_015_000, 1_045_000, None)]
    assert traceview.idle_by_span(bare, spans) == pytest.approx(
        {"train.step": 50e-6, "train.backward": 20e-6, "(outside spans)": 40e-6,
         "cudaLaunchKernel": 20e-6})  # thread 3's launch spans 170
    logdir = tmp_path / "t"
    logdir.mkdir()
    (logdir / "a.pt.trace.json").write_text(json.dumps(_idle_trace()))
    assert traceview.idle_by_span(str(logdir)) == got


def test_report_by_scope_matches_the_port_spans_by_default(tmp_path, capsys):
    events = [_x("user_annotation", "cluster.rerank", 0, 100),
              _x("cpu_op", "rerank.l1", 10, 40), _x("cpu_op", "aten::mm", 15, 5),
              _x("user_annotation", "Optimizer.step#AdamW.step", 200, 50),
              _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=1),
              _x("cuda_runtime", "cudaLaunchKernel", 210, 2, correlation=2),
              _kernel(30, 5, 1), _kernel(215, 7, 2)]
    logdir = tmp_path / "r"
    logdir.mkdir()
    (logdir / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    r = traceview.report_by_scope(str(logdir))
    assert r["by_scope"] == {"cluster.rerank": 5, "(other)": 7}
    assert traceview.report_by_scope(str(logdir), r"^rerank\.\w+$")["by_scope"] == {
        "rerank.l1": 5, "(other)": 7}
    capsys.readouterr()


@pytest.mark.cuda
def test_device_spans_resolve_their_events_without_a_synchronise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events)")
    x = torch.ones(8, device="cuda")
    with profiling.record_spans():  # load the kernels and the events' code first
        with profiling.span("cluster.dbscan", device=True):
            torch.cuda._sleep(1000)
            x.add_(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any synchronising call raises
    try:
        with profiling.record_spans():
            with profiling.span("cluster.dbscan", key=0, device=True):
                torch.cuda._sleep(50_000_000)
                x.add_(1)
            with profiling.span("cluster.readback"):
                pass
            early = profiling.recorded()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert early.of("cluster.dbscan")[0].device_ms is None  # the stream is not there yet
    torch.cuda.synchronize()
    rec = profiling.recorded()
    (s,) = rec.of("cluster.dbscan")
    assert s.device_ms > 1.0 and rec.device_ms("cluster.dbscan") == s.device_ms
    assert rec.of("cluster.readback")[0].device_ms is None
