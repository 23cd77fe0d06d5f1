"""The port's profiling harness and trace reader (``utils.profiling``,
``utils.traceview``) on the CPU: ``wallclock``'s keys against the JAX
package's, ``trace`` writing a Chrome trace, ``report_by_scope`` on a small
hand-written trace of the torch profiler's layout, and
``device_memory_stats`` returning ``{}`` for the CPU."""

import gzip
import json

import jax
import jax.numpy as jnp
import torch

from ssg_tpu.utils import profiling as jax_profiling

from ssg_tpu_torch.utils import profiling, traceview


def test_wallclock_keys_match_jax():
    stats = profiling.wallclock(lambda x: (x @ x).sum(), torch.ones(32, 32), iters=3, warmup=1)
    ref = jax_profiling.wallclock(jax.jit(lambda x: (x @ x).sum()), jnp.ones((32, 32)),
                                  iters=3, warmup=1)
    assert set(stats) == set(ref) and stats["iters"] == 3
    assert 0 <= stats["min_s"] <= stats["p50_s"] <= stats["max_s"]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with torch.profiler.record_function("ssg_matmul"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (path,) = logdir.glob("*.pt.trace.json.gz")
    trace = traceview.load_latest(str(logdir))
    assert trace == json.loads(gzip.open(path, "rt").read())
    assert any(e.get("cat") == "user_annotation" and e["name"] == "ssg_matmul"
               for e in trace["traceEvents"])
    # No card: no device events, so nothing to attribute.
    assert traceview.report_by_scope(str(logdir))["device_events"] == 0
    assert traceview.report_by_scope(str(tmp_path / "absent")) is None


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def test_report_by_scope_on_a_hand_written_trace(tmp_path, capsys):
    """Device events are attributed through their launch's correlation id
    to the outermost matching ``record_function`` range on the launching
    thread; launches outside one, device events without a launch, and
    ranges that ``scope_re`` does not match count as ``(other)``."""
    events = [
        _x("user_annotation", "ssg_outer", 0, 100), _x("user_annotation", "ssg_inner", 10, 40),
        _x("user_annotation", "unscoped", 200, 100),
        _x("user_annotation", "ssg_elsewhere", 0, 1000, tid=2),  # another thread's range
        _x("cpu_op", "aten::mm", 15, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 70, 2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 2, correlation=4),
        _x("kernel", "void l1_kernel<8, 4>", 30, 5, pid=0, tid=7, correlation=1),
        _x("kernel", "sm90_xmma_fprop", 65, 7, pid=0, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 75, 3, pid=0, tid=7, correlation=3),
        _x("kernel", "elementwise", 260, 11, pid=0, tid=7, correlation=4),
        _x("kernel", "orphan", 400, 13, pid=0, tid=7, correlation=99),
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
    ]
    logdir = tmp_path / "hand"
    logdir.mkdir()
    (logdir / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    r = traceview.report_by_scope(str(logdir), r"ssg_\w+", divisor=2)
    assert r["device_events"] == 5 and r["total_us"] == (5 + 7 + 3 + 11 + 13) / 2
    assert r["by_scope"] == {"ssg_outer": (5 + 7 + 3) / 2, "(other)": (11 + 13) / 2}
    assert r["by_op"][("ssg_outer", "void l1_kernel<8, 4>")] == 2.5
    out = capsys.readouterr().out
    assert "ssg_outer" in out and "top ops" in out


def test_device_memory_stats_is_empty_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == {}
