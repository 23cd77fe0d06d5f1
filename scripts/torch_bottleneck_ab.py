#!/usr/bin/env python3
"""A port kernel against another version of its source, in turns on one
CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    git show <rev>:ssg_tpu_torch/csrc/bottleneck.cu > .archive/bottleneck_old.cu
    python3 scripts/torch_bottleneck_ab.py --baseline .archive/bottleneck_old.cu
    python3 scripts/torch_bottleneck_ab.py --dtype float32 --baseline .archive/bottleneck_old.cu
    python3 scripts/torch_bottleneck_ab.py --kernel l1 --baseline .archive/l1_old.cu
    python3 scripts/torch_bottleneck_ab.py --kernel distance --baseline .archive/distance_old.cu

It builds ``ssg_tpu_torch/csrc/<kernel>.cu`` and the baseline with the port's
``nvcc`` flags (``ops._build``), one ``nvcc`` each, checks both against the
plain version and times them in turns: current, baseline, baseline, current,
for ``--rounds`` rounds. It prints the median device ms of each, then the
card's name and power limit.

* ``bottleneck`` (the default; the baseline has the same C interface): at
  each ResNet-50 path shape (batch 128, 256x128 input; random bf16
  activations and folded weights from seed 0), per layer, one identity
  block and the stage's first (downsample) block (stride 1 in layer1, 2 in
  layers 2-4), then the 12 identity blocks (2, 3, 5 and 2 in layers 1-4)
  and the 4 downsample blocks of a batch. Each line also gives each
  version's host time a launch (the C call, tensor maps included). With
  ``--dtype float32`` the same blocks run in fp32 through
  ``ssg_bottleneck_f32`` (activations, weights and workspaces fp32), each
  checked within ``FP32_REL`` of the largest output of the plain version in
  true fp32.
* ``l1`` and ``distance``: the path call, a symmetric one (N = 3368; the L1
  on a V-like sparse row-stochastic matrix against itself, the distance on
  unit-norm rows of width 2048 against themselves), then the general call at
  (1000, 777) x (333, 777). A baseline from before the ``symmetric``
  argument (its source has none) computes the full matrix. Each line gives
  each version's error against the plain version and, for the L1, whether
  the two outputs are bit-identical (both sum every output's k in order).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ssg_tpu_torch.ops import _build, bottleneck  # noqa: E402
from ssg_tpu_torch.ops.bottleneck import bf16_ulp_error, block_ref  # noqa: E402
from ssg_tpu_torch.ops.distance import pairwise_distance_ref  # noqa: E402
from ssg_tpu_torch.ops.l1 import l1_distance_ref  # noqa: E402

# (name, H, W, C, Cm, identity blocks a batch) at batch 128.
LAYERS = (("layer1", 64, 32, 256, 64, 2), ("layer2", 32, 16, 512, 128, 3),
          ("layer3", 16, 8, 1024, 256, 5), ("layer4", 8, 4, 2048, 512, 2))
# Each stage's first block at batch 128: (name, H, W, C, Cm, Cout, stride).
DOWNSAMPLE = (("layer1", 64, 32, 64, 64, 256, 1), ("layer2", 64, 32, 256, 128, 512, 2),
              ("layer3", 32, 16, 512, 256, 1024, 2), ("layer4", 16, 8, 1024, 512, 2048, 2))
BATCH = 128
BF16_ULPS = 4  # kernel against the plain version, as in chip_smoke.py
FP32_REL = 1e-4  # fp32 blocks: of max |ref|, as in chip_smoke.py
L1_TOL = DIST_TOL = 1e-5  # of the row-sum / |x|^2 + |y|^2 scale, as in chip_smoke.py
N = 3368  # the path's points a group


def block(gen: np.random.Generator, c: int, cm: int, dev, cout: int | None = None,
          dtype: torch.dtype = torch.bfloat16):
    """Folded-block weights, LeCun-scaled in ``dtype`` and small fp32 biases;
    with ``cout``, a downsample block (``wd``, ``bd`` last)."""
    ds = cout is not None
    cout = c if cout is None else cout
    shapes = [(c, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    shapes += [(c, cout), (cout,)] if ds else []
    out = []
    for shape in shapes:
        a = gen.normal(size=shape).astype(np.float32)
        if len(shape) > 1:
            out.append(torch.from_numpy(a * np.prod(shape[:-1]) ** -0.5).to(dev, dtype))
        else:
            out.append(torch.from_numpy(a * 0.1).to(dev))
    return out


def median_ms(fns: dict, rounds: int, reps: int, host: dict | None = None) -> dict:
    """Median device ms of each callable, timed in turns (a, b, b, a) per
    round; with ``host``, also each one's median host ms a call (the enqueue
    loop's own clock)."""
    def timed(k):
        fn = fns[k]
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if host is not None:
            host.setdefault(k, []).append(host_s * 1e3 / reps)
        return start.elapsed_time(end) / reps

    names = list(fns)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(timed(k))
    if host is not None:
        for k in names:
            host[k] = statistics.median(host[k])
    return {k: statistics.median(v) for k, v in times.items()}


def ab_bottleneck(libs: dict, dev, rounds: int, reps: int, dtype: torch.dtype) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    gen = np.random.default_rng(0)
    f32 = dtype == torch.float32
    cases = [(f"{name} identity block", (BATCH, h, w, c), c, cm, c, 1, count)
             for name, h, w, c, cm, count in LAYERS]
    cases += [(f"{name} downsample block", (BATCH, h, w, c), c, cm, cout, s, 1)
              for name, h, w, c, cm, cout, s in DOWNSAMPLE]
    totals = {kind: dict.fromkeys(libs, 0.0) for kind in ("identity", "downsample")}
    for label, shape, c, cm, cout, stride, count in cases:
        ds = "downsample" in label
        x = torch.from_numpy(np.abs(gen.normal(size=shape)).astype(np.float32)).to(dev, dtype)
        ws = block(gen, c, cm, dev, cout if ds else None, dtype)
        ref = block_ref(x, *ws, stride=stride)
        out = torch.empty_like(ref)
        b, h, w = shape[:3]
        # fp32: the workspaces y1, y2 and a downsample block's residual.
        work = ([torch.empty((b, h, w, cm), dtype=dtype, device=dev),
                 torch.empty(ref.shape[:3] + (cm,), dtype=dtype, device=dev),
                 torch.empty_like(ref) if ds else None] if f32 else [])

        def run(lib):
            ptrs = [t.data_ptr() for t in ws] + ([] if ds else [None, None])
            ptrs += [out.data_ptr()] + [None if t is None else t.data_ptr() for t in work]
            fn = lib.ssg_bottleneck_f32 if f32 else lib.ssg_bottleneck

            def go():
                err = fn(x.data_ptr(), *ptrs, b, h, w, c, cm, cout, stride, stream)
                if err:
                    raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
            return go

        for k, lib in libs.items():
            out.zero_()
            run(lib)()
            torch.cuda.synchronize()
            if f32:
                rel = float((out - ref).abs().max()) / float(ref.abs().max())
                if rel > FP32_REL:
                    raise RuntimeError(f"{label} ({k}): rel {rel:.2e} from the plain version")
            else:
                ulps = bf16_ulp_error(out, ref)
                if ulps > BF16_ULPS:
                    raise RuntimeError(f"{label} ({k}): {ulps:.0f} ulps from the plain version")
        host = {}
        med = median_ms({k: run(lib) for k, lib in libs.items()}, rounds, reps, host)
        kind = "downsample" if ds else "identity"
        for k in libs:
            totals[kind][k] += count * med[k]
        print(f"{label} {shape}/Cm {cm}/Cout {cout}/stride {stride}: " +
              ", ".join(f"{k} {v:.4f} ms (host {host[k] * 1e3:.1f} us)" for k, v in med.items()) +
              f"; current / baseline {med['current'] / med['baseline']:.3f}")
    for kind, n in (("identity", 12), ("downsample", 4)):
        print(f"{n} {kind} blocks a batch ({dtype}): " +
              ", ".join(f"{k} {v:.4f} ms" for k, v in totals[kind].items()))


def bind_pairwise(kernel: str, source: Path):
    """The C function of an L1 or distance source, with its argument types;
    ``has_symmetric`` is False for a source from before the symmetric flag."""
    fn = getattr(_build.load(source), {"l1": "ssg_l1_distance",
                                       "distance": "ssg_pairwise_distance"}[kernel])
    has_symmetric = "int symmetric" in source.read_text()
    flags = int(has_symmetric) + int(kernel == "distance")  # symmetric, squared
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_int] * flags + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, has_symmetric


def ab_pairwise(kernel: str, libs: dict, dev, rounds: int, reps: int) -> bool:
    """Times both versions at each shape; False if one disagrees with the
    plain version (reported, and still timed)."""
    ok = True
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "l1":
        cols = torch.randint(0, N, (N, 180), generator=gen, device=dev)
        path = torch.zeros((N, N), device=dev).scatter_add_(
            1, cols, torch.rand((N, 180), generator=gen, device=dev))
        path /= path.sum(1, keepdim=True)
        ref_fn, tol = l1_distance_ref, L1_TOL
    else:
        path = torch.randn((N, 2048), generator=gen, device=dev)
        path /= path.norm(dim=1, keepdim=True)
        ref_fn, tol = pairwise_distance_ref, DIST_TOL
    general = (torch.randn((1000, 777), generator=gen, device=dev),
               torch.randn((333, 777), generator=gen, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    for label, x, y in (("path, symmetric", path, path), ("general", *general)):
        m, d = x.shape
        n = y.shape[0]
        sym = int(x is y)
        outs = {k: torch.empty((m, n), device=dev) for k in libs}

        def run(k):
            fn, has_symmetric = libs[k]
            args = [x.data_ptr(), y.data_ptr(), outs[k].data_ptr(), m, n, d, d, d, n]
            args += [sym] if has_symmetric else []
            args += [1] if kernel == "distance" else []  # squared

            def go():
                err = fn(*args, stream)
                if err:
                    raise RuntimeError(f"{kernel} ({k}): CUDA error {err}")
            return go

        ref = ref_fn(x, y)
        if kernel == "l1":
            scale = float(x.abs().sum(1).max() + y.abs().sum(1).max())
        else:
            scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        errs = {}
        for k in libs:
            run(k)()
            torch.cuda.synchronize()
            errs[k] = float((outs[k] - ref).abs().max()) / scale
            if errs[k] > tol:
                print(f"FAIL {kernel} {label} ({k}): rel error {errs[k]:.3e} > {tol}")
                ok = False
        if sym and not torch.equal(outs["current"], outs["current"].T):
            print(f"FAIL {kernel} {label}: current output not exactly symmetric")
            ok = False
        med = median_ms({k: run(k) for k in libs}, rounds, reps)
        same = (f"; outputs bit-identical: {torch.equal(outs['current'], outs['baseline'])}"
                if kernel == "l1" else "")
        print(f"{kernel} {label} ({m},{d})x({n},{d}): " +
              ", ".join(f"{k} {med[k]:.4f} ms (rel err {errs[k]:.2e})" for k in libs) +
              f"; current / baseline {med['current'] / med['baseline']:.3f}{same}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("bottleneck", "l1", "distance"), default="bottleneck")
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another version of csrc/<kernel>.cu")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the bottleneck's activations and weights")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bottleneck_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    baseline = args.baseline.resolve()
    _build.build([args.kernel, baseline])  # one nvcc each, together
    sources = {"current": _build.CSRC / f"{args.kernel}.cu", "baseline": baseline}
    ok = True
    if args.kernel == "bottleneck":
        ab_bottleneck({k: bottleneck.bind(_build.load(src)) for k, src in sources.items()},
                      dev, args.rounds, args.reps, getattr(torch, args.dtype))
    else:
        ok = ab_pairwise(args.kernel, {k: bind_pairwise(args.kernel, src)
                                       for k, src in sources.items()}, dev, args.rounds, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
