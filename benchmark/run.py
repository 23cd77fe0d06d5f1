"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes every input and the weights from
``--seed`` on the card and warms up the cell's shapes; the window then
drives the program for ``--seconds``; with ``--trace 1`` one more unit of
the same calls (an epoch or a pass) follows under ``torch.profiler`` and the per-layer metrics
are read from it, otherwise the end-to-end ones are reported. Once the
window has closed and the program's state is freed, the plain reference
judges what the timed path produced. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` with ``--trace 1``), with each number
compared beside its limit under ``checks``, last. Exits 3 without a
result where there is no card or fewer than the cell asks for, and 4 where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def _process_start() -> float:
    """The process's start on the host clock (Linux), else this module's import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= _T_START else _T_START
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_START


def main(argv=None, device=None, root: Path | None = None) -> int:
    """``device``: None runs on the card and requires it; a test passes
    ``"cpu"`` to drive the rest of a run without one."""
    t0 = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    root = ROOT if root is None else Path(root)
    if device is None:
        # One intra-op thread: the host work a step needs is the launching
        # thread's and the trainer's producer thread's, and idle worker
        # threads spinning beside them on the shared host slowed the
        # launches and spread the runs.
        torch.set_num_threads(1)
        cell = harness.Cell.load(root, args.workload, args.seed)
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}",
                  file=sys.stderr)
            return 3
        cell.device = torch.device("cuda", 0)
    else:
        cell = harness.Cell.load(root, args.workload, args.seed, torch.device(device))
    on_card = cell.device.type == "cuda"

    with contextlib.redirect_stdout(sys.stderr):  # the program's prints
        state = cell.kind.setup(cell)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.time() - t0
        res = cell.kind.window(cell, state, args.seconds)
        print("window units (s): " + " ".join(f"{u:.4f}" for u in res["units"]), file=sys.stderr)
        traced = None
        if args.trace:
            traced = harness.profile_slice(lambda: cell.kind.traced_slice(cell, state))
        peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
        outputs = cell.kind.collect(cell, state)
        del state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        readings, extra = cell.kind.check(cell, outputs)

    ok, checks = harness.judge(readings, cell.limits)
    checks["failed"] = {"value": res["failed"], "limit": 0}
    correct = ok and res["failed"] == 0
    metrics = {}
    if args.trace:
        info = {"trace": traced, "counts": {**traced["counts"], **extra}}
        for m in cell.per_layer():
            value = cell.metric_reader(m["name"]).read(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**res["metrics"], "setup_s": setup_s}
        for m in cell.end_to_end():
            if on_card or m["name"] in values:  # the CPU has no stream events
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4

    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
                         "count": int(cell.workload["chips"]) if on_card else 0,
                         "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    for name, value in readings.items():
        if name not in checks:
            print(f"reading {name}: {value} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
