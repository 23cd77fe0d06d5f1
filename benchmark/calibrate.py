"""Readings for the limits of a cell's comparison, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1] [--fault F]

For each seed, in one process: the cell's set-up, one unit of its window
where the cell judges a window's output (one extract or clustering pass;
a train cell's checked steps run in set-up), the plain reference, and the
numbers compared (``program``); with ``--control 1`` also the control (the
reference in the precision below the configuration's, in the program's
place) against the reference; with ``--fault`` the program runs with that
fault planted (``faults.py``). One JSON line a seed on standard output.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def main(argv=None, device=None, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell.load(ROOT if root is None else Path(root), args.workload, seed, dev)
        t0 = time.time()
        with faults.plant(args.fault):
            st = cell.kind.setup(cell)
            if cell.mix["kind"] != "train":
                cell.kind.window(cell, st, 0.0)
            out = cell.kind.collect(cell, st)
        del st
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "program": cell.kind.check(cell, out)[0]}
        if args.control:
            line["control"] = cell.kind.control(cell, out)
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
