#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ssg_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_smoke.py

It drives six paths through the port's entry points at full width, the
first two on bench config-1's workload (``bench.py``): SSG ResNet-50 (bf16,
random weights from seed 0) extracting 3 part groups from N = 3368 synthetic
Market-1501 images in batches of 128, then per group k-reciprocal
re-ranking (k1=20, k2=6, lambda=0.1), rho-quantile eps (rho=1.6e-3) and
DBSCAN (min_samples=4):

* path 1, the main path (config-1): the unfused model, cuBLAS distances and
  the CUDA L1 kernel in the re-ranking;
* path 2, fused-eval: the same weights with ``fused_eval=True``, whose 12
  identity bottlenecks run the CUDA bottleneck kernel, then the analytics
  with the CUDA distance kernel (``dist_impl="kernel"``);
* path 3, fine-tuning (``train_phases``): T1, one fp32 train step of
  ResNet-50 at full width (batch 8) on the card against the same step on
  the CPU; T2, the bf16 train step at batch 64 (P 16 x K 4), timed; T3,
  ``api.train`` (``run_ssg``) for two iterations on synthetic DukeMTMC at
  scale 0.2 (1120 train images), the second resumed from the first's
  checkpoint, its ``cluster_groups`` launching the CUDA L1 kernel;
* path 4, the command-line workflow (``cli_phases``), through the CLIs'
  ``main(argv)`` at full width (bf16 ResNet-50, batch 64, K 4, seed 0): P1,
  ``cli.pretraining`` (softmax + triplet) on synthetic Market-1501 at scale
  0.1 (600 images, 75 identities) for 2 epochs, evaluated on DukeMTMC; P2,
  the same with ``--loss oim`` for 1 epoch; P3, ``cli.selftraining
  --resume`` of P1's checkpoint on DukeMTMC at scale 0.2, 1 iteration of 2
  epochs, ``--rerank`` (4 L1 kernel launches); P4, ``cli.semitraining
  --resume`` of the same checkpoint, 1 iteration (fresh target-sized
  heads); P5, the bf16 train step with and without ``remat``; P6,
  ``evaluation_metrics`` (``cmc`` with its flags, ``mean_ap``,
  ``accuracy``) on the card against the same calls on the CPU;
* path 5, large N (``l5_streaming_tile``, ``e1_e2_eval``, ``c1_c2_cluster``),
  on seeded clustered features at full width (the standard splits' sizes;
  features, since rendering some 19k images on the host would take
  minutes): L5, the L1 kernel's general path on the streaming tile, one
  (512, npad) chunk of a V-like matrix against the whole at E1's npad; E1,
  ``streaming_rerank_eval`` at the Market-1501 test split (3,368 query and
  15,913 gallery images, 6,144-d) against the dense ``re_ranking`` +
  ``evaluate_all``; E2, ``Evaluator.evaluate(rerank=True)`` on the same
  features, routed to streaming by the unchanged threshold; C1,
  ``streaming_cluster_groups`` at the DukeMTMC train split (16,522 x 3
  groups of 2048-d) against the dense ``cluster_groups``, then group 0 with
  the forced fallback (``band_cap=0``); C2, ``streaming_cluster`` at the
  MSMT17 train split (32,621) against the dense chain;
* path 6, the on-disk workflow (``data_dir_phases``): D1 writes a raw
  DukeMTMC-reID tree of P3's target (x0.2: 1120 train, 280 query, 560
  gallery images) from the renderer, as PPM bytes under the benchmark's
  names (5 gallery files at 128x64, 3 junk files), and prepares it with
  ``cli.prepare``; D2, ``cli.selftraining --data_dir --resume <P1>
  --rerank`` on it (ResNet-50, P3's flags); D3, the Inception at full width
  (depth 8, width 64, bf16): ``cli.pretraining --arch inception`` on
  Market-1501 x0.1 for 1 epoch, then ``cli.selftraining --arch inception
  --data_dir --resume --rerank`` (batch 32), its train step as T2, its
  extract in turns with ResNet-50's, its fp32 eval on the card against the
  CPU and remat as P5; D4, KISSME on D2's whole-body features on the card
  and the CPU, ``DistanceMetric("kissme").train``, ``extract_cnn_feature``,
  ``profiling.trace`` read back by ``traceview.report_by_scope``,
  ``device_memory_stats`` and, where h5py is installed,
  ``FeatureDatabase``.

It checks them:

1. builds every CUDA kernel from ``ssg_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card at
   ragged shapes and at the path shapes (the L1 and distance kernels also
   at ragged symmetric shapes, y being x, where their output must be
   exactly symmetric; the bottleneck on activations captured from the path
   model, with its folded weights; its fp32 kernel on random fp32 blocks,
   against the plain version in true fp32);
3. runs each path once as warm-up and once timed, with the kernels' launch
   counts set to 0 just before and read just after;
4. checks the outputs (shapes, finiteness, unit-norm embeddings, label
   structure; path 1's labels against the port's CPU path on a subset and
   against the plain L1 on the card; path 2's embeddings against path 1's
   and its labels against path 1's; the distance kernel's analytics against
   those on exact, fp64 distances);
5. times each kernel, its plain version and the nearest PyTorch library
   form, at the path shapes, beside the least time the card could take
   for the call's work (a symmetric call needs N(N+1)/2 pairs; the
   bottleneck also beside its times in PERF.md);
6. runs path 3 and checks it: T1's loss and gradients against the CPU, T2's
   loss falling on its repeated batch, T3's finite losses, training in each
   iteration, the reloaded checkpoint's embeddings (bit for bit) and the
   optimizer state restored on resume;
7. runs path 4 and checks it: each CLI exits 0; P1's epochs train and its
   evaluation is in range; P2's touched table rows have unit norm and the
   others are 0; P3 and P4 train and evaluate, with 4 and 3 L1 kernel
   launches, and P4 keeps heads sized to the target; P5's losses and BN
   statistics agree within 1e-3 relative over 5 steps and remat's peak
   memory is below the plain step's; P6's first-match curves and accuracy
   equal the CPU's, and its allshots curves and mAP are within 1e-6;
8. runs path 5 and checks it: L5's kernel against its plain version; E1
   within 1e-4 of the dense mAP and 2 / Q of its rank-1/5/10, with one L1
   launch a query chunk; E2 equal to E1; C1 and C2 with 99.9 % of points in
   the dense chain's clusters, equal counts and eps within 1e-5, per group,
   the fast path engaged on at least one group of C1, and the forced
   fallback held to the same gates; it prints seconds and peak memory of
   streaming and dense, and the largest N each would fit on the card,
   extrapolated from C2;
9. runs path 6 and checks it: D1's split sizes (the raw tree's less the
   junk), ``meta.json`` and every 256x128 image decoded byte for byte, with
   the decoder that ran (``decoder: native`` or ``pil``, the native build's
   error where it failed) and the host decode rates; D2 and D3's
   selftraining train, evaluate and launch the L1 kernel 4 times, D2's
   embeddings of the disk images against those of the rendered pixels
   (per-row cosine >= 0.99999); D3's classifier sized 75 x 1024, its extract
   1024-d, its fp32 embeddings within 1e-4 of the CPU's, remat as P5; D4's
   KISSME fits each within the fp32 perturbation estimate of the fp64 fit,
   ``extract_cnn_feature`` equal to ``api.extract_features``, and the trace
   holding convolution kernels in its extract scope and the L1 kernel in
   its clustering scope.

Any failed check ends the run with a nonzero exit. The last seven lines
are path 3's ``train`` JSON, path 4's ``cli`` JSON, path 5's ``large_n``
JSON, path 6's ``data_dir`` JSON, the kernels' JSON, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import torch.nn.functional as F

from ssg_tpu_torch import api, models, resolve_device
from ssg_tpu_torch.cli import prepare as prepare_cli
from ssg_tpu_torch.cli import pretraining, selftraining, semitraining
from ssg_tpu_torch.cluster import dbscan, select_eps
from ssg_tpu_torch.data import Preprocessor, datasets, native_loader, transforms
from ssg_tpu_torch.data.synthetic import RAW_H, RAW_W
from ssg_tpu_torch.dist_metric import DistanceMetric
from ssg_tpu_torch.evaluation_metrics import accuracy, cmc, mean_ap
from ssg_tpu_torch.feature_extraction import FeatureDatabase, extract_cnn_feature
from ssg_tpu_torch.feature_extraction import database as feature_database
from ssg_tpu_torch.metric_learning import KISSME
from ssg_tpu_torch.ops import _build, bottleneck, bottleneck_stage, distance, l1
from ssg_tpu_torch.ops.bottleneck import bf16_ulp_error, bottleneck_ref, fused_bottleneck
from ssg_tpu_torch.ops.bottleneck_stage import fused_bottleneck_stage, stage_ref
from ssg_tpu_torch.ops.distance import pairwise_distance, pairwise_distance_ref
from ssg_tpu_torch.ops.rerank import _encode, _re_ranking_impl
from ssg_tpu_torch.parallel import (streaming_cluster, streaming_cluster_groups,
                                    streaming_rerank_eval)
from ssg_tpu_torch.train.schedule import make_optimizer
from ssg_tpu_torch.train.ssg_loop import SSGConfig
from ssg_tpu_torch.train.trainer import make_train_step
from ssg_tpu_torch.utils import load_checkpoint, profiling, read_json, traceview

N = 3368
BATCH = 128
K1, K2, LAMBDA, RHO, MIN_SAMPLES = 20, 6, 0.1, 1.6e-3, 4
ANALYTICS = dict(k1=K1, k2=K2, lambda_value=LAMBDA, rho=RHO, min_samples=MIN_SAMPLES)
L1_TOL = 1e-5  # of the row-sum scale: fp32 sums in another order
DIST_TOL = 1e-5  # of the |x|^2 + |y|^2 scale: fp32 sums in another order
# bf16 blocks: y1, y2 and the output round to bf16 on both sides, and fp32
# sums in another order can flip one of those roundings: ulps of
# max(|ref|, rms(ref)) (bottleneck.bf16_ulp_error), per block of a run, since
# each block passes its input's differences on through the residual.
BF16_ULPS = 4
FP32_REL = 1e-4  # fp32 blocks against the plain version: of max |ref|, sums in another order
COSINE_MIN = 0.99  # fused-eval embeddings against the unfused path's, per row
# H100 SXM (NVIDIA data sheet): 3.35 TB/s; fp32 67 TFLOP/s counts an FMA as
# two operations, so plain fp32 adds and subtracts (the L1 has no FMA form)
# run at half that: 132 SMs x 128 lanes x 1.98 GHz. Dense tensor cores: bf16
# 989 TFLOP/s, TF32 495 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_NON_FMA_PER_S = 132 * 128 * 1.98e9
FP32_FMA_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# Ragged symmetric sizes for the L1 and distance kernels (y is x).
SYMMETRIC_N = (1, 5, 65, 130, 1000, 1283)
# ResNet-50 stages: (name, blocks, stride of the first block).
STAGES = (("layer1", 3, 1), ("layer2", 4, 2), ("layer3", 6, 2), ("layer4", 3, 2))
# Identity blocks at the path shapes (batch 128): (name, H, W, C, Cm, blocks a batch).
IDENTITY = (("layer1", 64, 32, 256, 64, 2), ("layer2", 32, 16, 512, 128, 3),
            ("layer3", 16, 8, 1024, 256, 5), ("layer4", 8, 4, 2048, 512, 2))
# The bottleneck kernel's times at the path shapes as PERF.md records them
# for this version of it (H100 80GB HBM3, 700 W): one identity block a
# layer; a batch's 12 identity blocks and four stages.
RECORDED_BLOCK_MS = {"layer1": 0.623, "layer2": 0.413, "layer3": 0.376, "layer4": 0.667}
RECORDED_BATCH_MS = {"fused_bottleneck": 5.701, "fused_bottleneck_stage": 10.217}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def l1_errors(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    """(max abs error, error / row-sum scale) of the kernel against the plain
    version; when ``y`` is ``x`` the kernel's output must be exactly symmetric."""
    out = l1.l1_distance(x, y)
    ref = l1.l1_distance_ref(x, y)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"L1 kernel output bad at {tuple(x.shape)}x{tuple(y.shape)}")
    if y is x:
        check(torch.equal(out, out.T), f"L1 kernel output not symmetric at {tuple(x.shape)}")
    err = float((out - ref).abs().max())
    scale = float(x.abs().sum(1).max() + y.abs().sum(1).max())
    return err, err / max(scale, 1e-30)


def pairs(m: int, n: int, symmetric: bool) -> int:
    """Output pairs an all-pairs call must compute: m n, or m (m + 1) / 2 when
    y is x (the rest are mirrored)."""
    return m * (m + 1) // 2 if symmetric else m * n


def l1_bound_ms(m: int, n: int, d: int, symmetric: bool = False) -> tuple[float, str]:
    """Least time for an L1 call: two fp32 instructions a pair and element, or
    reading x (and y) and writing out once."""
    ops_s = 2.0 * pairs(m, n, symmetric) * d / FP32_NON_FMA_PER_S
    bytes_s = 4.0 * (m * d + (0 if symmetric else n * d) + m * n) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def path_model(dev: torch.device, fused_eval: bool = False):
    """The bf16 SSG ResNet-50 with random weights from seed 0, on ``dev``."""
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16,
                          fused_eval=fused_eval)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval().to(dev, memory_format=torch.channels_last)


def main_path_inputs(dev: torch.device):
    """The bench config-1 image batches, rendered on the host and uploaded,
    and the bf16 SSG ResNet-50 with random weights from seed 0, on ``dev``."""
    ds = datasets.create("market1501", scale=0.45, seed=0)
    items = (ds.train + ds.query + ds.gallery)[:N]
    check(len(items) == N, f"synthetic dataset too small: {len(items)}")
    t0 = time.perf_counter()
    batches = [(torch.from_numpy(im).to(dev), p, c, mk)
               for im, p, c, mk in Preprocessor(ds, items=items, batch_size=BATCH)]
    torch.cuda.synchronize()
    print(f"render + upload {len(batches)} batches: {time.perf_counter() - t0:.1f} s")
    return batches, path_model(dev)


def dist_bound_ms(m: int, n: int, d: int, symmetric: bool = False,
                  route: str = "fma") -> tuple[float, str]:
    """Least time for a distance call at fp32 accuracy: its products on the
    fp32 FMA pipes (``route="fma"``), or as three TF32 tensor-core products
    (``"3xtf32"``: hi.hi + hi.lo + lo.hi); or reading x (and y) and writing
    out once."""
    flop = 2.0 * pairs(m, n, symmetric) * d
    ops_s = flop / FP32_FMA_FLOP_PER_S if route == "fma" else 3.0 * flop / TF32_FLOP_PER_S
    bytes_s = 4.0 * (m * d + (0 if symmetric else n * d) + m * n) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def block_work(x_shape, blk, stride: int) -> tuple[float, float, tuple]:
    """(operations, weight bytes, output shape) of one folded block on NHWC ``x_shape``."""
    b, h, w, c = x_shape
    cm, cout = blk[0].shape[1], blk[4].shape[1]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    macs = b * h * w * c * cm + b * ho * wo * (9 * cm * cm + cm * cout)
    if len(blk) == 8:
        macs += b * ho * wo * c * cout
    wbytes = sum(t.numel() * t.element_size() for t in blk)
    return 2.0 * macs, wbytes, (b, ho, wo, cout)


def blocks_bound_ms(x_shape, blocks, stride: int) -> tuple[float, str]:
    """Least time for a run of folded blocks: its products on the bf16 tensor
    cores, or reading its input and weights and writing its output once."""
    ops, nbytes, shape = 0.0, 2.0 * float(np.prod(x_shape)), tuple(x_shape)
    for i, blk in enumerate(blocks):
        o, wb, shape = block_work(shape, blk, stride if i == 0 and len(blk) == 8 else 1)
        ops += o
        nbytes += wb
    nbytes += 2.0 * float(np.prod(shape))
    ops_s, bytes_s = ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def eager_blocks(blocks, stride: int):
    """The nearest library form of a run of folded blocks: cuDNN convolutions
    with the same folded bf16 weights (bias in bf16) and eager ReLU / add, on
    channels-last NCHW. Returns ``fn(x_nhwc) -> out_nhwc``."""
    def conv_w(w):  # (Cin, Cout) or HWIO -> OIHW, channels-last
        w = w[None, None] if w.dim() == 2 else w
        return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    prepared = [([conv_w(w) for w in blk[0::2]], [b.to(torch.bfloat16) for b in blk[1::2]])
                for blk in blocks]

    def run(x):
        x = x.permute(0, 3, 1, 2)
        for i, (ws, bs) in enumerate(prepared):
            s = stride if i == 0 and len(ws) == 4 else 1
            y = F.conv2d(x, ws[0], bs[0]).relu_()
            y = F.conv2d(y, ws[1], bs[1], stride=s, padding=1).relu_()
            y = F.conv2d(y, ws[2], bs[2])
            res = x if len(ws) == 3 else F.conv2d(x, ws[3], bs[3], stride=s)
            x = y.add_(res).relu_()
        return x.permute(0, 2, 3, 1)

    return run


def random_block(gen: torch.Generator, cin: int, cm: int, cout: int, ds: bool, dev):
    """Folded-block weights with LeCun-scaled normal entries (bf16) and small biases."""
    shapes = [(cin, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, cout), (cout,)]
    shapes += [(cin, cout), (cout,)] if ds else []
    out = []
    for shape in shapes:
        t = torch.randn(shape, generator=gen, device=dev)
        if len(shape) > 1:
            t = (t * float(np.prod(shape[:-1])) ** -0.5).to(torch.bfloat16)
        out.append(t * 0.1 if len(shape) == 1 else t)
    return tuple(out)


def check_kernels_ragged(dev: torch.device) -> None:
    """The bottleneck, stage and distance kernels against their plain
    versions at shapes ragged against their tiles, the distance kernel also
    at symmetric ones (y is x), whose output must be exactly symmetric."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def act(shape):
        return torch.randn(shape, generator=gen, device=dev).abs().to(torch.bfloat16)

    # The last four: grids of 1-3 blocks at the layer3-4 widths, and K = C,
    # 9 Cm and Cm straddling a 16-deep step of the products.
    for (b, h, w, c, cm) in [(2, 2, 1, 64, 16), (3, 5, 7, 32, 8), (2, 9, 13, 40, 8),
                             (1, 70, 3, 64, 16), (3, 9, 13, 40, 8), (1, 9, 7, 1024, 256),
                             (3, 9, 7, 1024, 256), (1, 8, 4, 2048, 512)]:
        x, blk = act((b, h, w, c)), random_block(gen, c, cm, c, False, dev)
        err = bf16_ulp_error(fused_bottleneck(x, *blk), bottleneck_ref(x, *blk))
        print(f"bottleneck ragged ({b},{h},{w},{c})/Cm {cm}: {err:.0f} ulps")
        check(err <= BF16_ULPS, f"bottleneck kernel disagrees at ({b},{h},{w},{c})/{cm}")
    for (stride, h, w, c, cm) in [(2, 9, 7, 24, 8), (1, 16, 8, 16, 8), (2, 33, 17, 64, 16)]:
        x = act((2, h, w, c))
        blocks = (random_block(gen, c, cm, 4 * cm, True, dev),
                  random_block(gen, 4 * cm, cm, 4 * cm, False, dev))
        err = bf16_ulp_error(fused_bottleneck_stage(x, blocks, stride), stage_ref(x, blocks, stride))
        print(f"stage ragged (2,{h},{w},{c})/Cm {cm} stride {stride}: {err:.0f} ulps")
        check(err <= BF16_ULPS * len(blocks),
              f"stage kernel disagrees at (2,{h},{w},{c})/{cm} s{stride}")
    cases = [(1000, 333, 777, True), (5, 7, 3, False), (129, 257, 65, True)]
    # Symmetric: squared, as on the path (sqrt magnifies the diagonal's
    # near-0 residues beyond this tolerance).
    cases += [(n, None, d, True) for n, d in zip(SYMMETRIC_N, (5, 3, 65, 2048, 777, 130))]
    for (m, n, d, squared) in cases:
        x = torch.randn((m, d), generator=gen, device=dev)
        y = x if n is None else torch.randn((n, d), generator=gen, device=dev)
        out = pairwise_distance(x, None if n is None else y, squared=squared, impl="kernel")
        ref = pairwise_distance_ref(x, y, squared=squared)
        torch.cuda.synchronize()
        if n is None:
            check(torch.equal(out, out.T), f"distance kernel output not symmetric at ({m},{d})")
        scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        rel = float((out - ref).abs().max()) / (scale if squared else scale ** 0.5)
        print(f"distance ragged ({m},{d}) against {'itself' if n is None else f'({n},{d})'} "
              f"squared={squared}: rel {rel:.3e}")
        check(rel <= DIST_TOL, f"distance kernel disagrees at ({m},{n},{d})")


def check_fp32_blocks(dev: torch.device) -> None:
    """The bottleneck's fp32 kernel (``ssg_bottleneck_f32``) against the plain
    version in true fp32 at ragged shapes and in a downsample stage, then on
    one random identity block at each path width, timed beside the plain
    version and the fp32 FMA bound."""
    gen = torch.Generator(device=dev).manual_seed(2)

    def f32(blk):
        return tuple(t.float() for t in blk)

    def rel(out, ref):
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()), "fp32 output bad")
        return float((out - ref).abs().max()) / float(ref.abs().max())

    for (b, h, w, c, cm) in [(3, 5, 7, 32, 8), (2, 9, 13, 40, 8)]:
        x = torch.randn((b, h, w, c), generator=gen, device=dev).abs()
        blk = f32(random_block(gen, c, cm, c, False, dev))
        err = rel(fused_bottleneck(x, *blk), bottleneck_ref(x, *blk))
        print(f"fp32 bottleneck ragged ({b},{h},{w},{c})/Cm {cm}: rel {err:.2e}")
        check(err <= FP32_REL, f"fp32 bottleneck kernel disagrees at ({b},{h},{w},{c})/{cm}")
    x = torch.randn((2, 9, 7, 24), generator=gen, device=dev).abs()
    blocks = (f32(random_block(gen, 24, 8, 32, True, dev)),
              f32(random_block(gen, 32, 8, 32, False, dev)))
    err = rel(fused_bottleneck_stage(x, blocks, 2), stage_ref(x, blocks, 2))
    print(f"fp32 stage ragged (2,9,7,24)/Cm 8 stride 2: rel {err:.2e}")
    check(err <= FP32_REL, "fp32 stage disagrees at (2,9,7,24)/8 s2")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for name, h, w, c, cm, count in IDENTITY:
        x = torch.randn((BATCH, h, w, c), generator=gen, device=dev).abs()
        blk = f32(random_block(gen, c, cm, c, False, dev))
        err = rel(fused_bottleneck(x, *blk), bottleneck_ref(x, *blk))
        check(err <= FP32_REL, f"fp32 {name} identity block disagrees: rel {err:.2e}")
        r = dict(ms=cuda_ms(lambda: fused_bottleneck(x, *blk), 5),
                 plain_ms=cuda_ms(lambda: bottleneck_ref(x, *blk), 5),
                 bound_ms=block_work(tuple(x.shape), blk, 1)[0] / FP32_FMA_FLOP_PER_S * 1e3)
        print(f"fp32 {name} identity block {tuple(x.shape)}: rel {err:.2e}, kernel "
              f"{r['ms']:.3f} ms, plain (true fp32) {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms (operations, fp32 FMA)")
        for k in total:
            total[k] += count * r[k]
    print(f"fp32 fused_bottleneck per batch (12 identity blocks): kernel {total['ms']:.3f} ms, "
          f"plain {total['plain_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms, "
          f"{total['bound_ms'] / total['ms']:.1%} of bound")


def capture_stage_inputs(model, batch) -> dict:
    """NHWC inputs of every stage's first and second block, from one batch
    of ``model`` (forward pre-hooks)."""
    seen, hooks = {}, []
    for name, _, _ in STAGES:
        for i in (0, 1):
            blk = getattr(model.backbone, name)[i]
            hooks.append(blk.register_forward_pre_hook(
                lambda mod, args, key=(name, i): seen.__setitem__(key, args[0].permute(0, 2, 3, 1))))
    api.extract_features(model, [batch])
    for hk in hooks:
        hk.remove()
    torch.cuda.synchronize()
    return seen


def time_blocks(name: str, x, blocks, stride: int, kernel_fn, plain_fn, counter,
                recorded_ms: float | None = None) -> dict:
    """Check a run of folded blocks on ``x`` against its plain version, then
    time the kernel, the plain version and the eager cuDNN form."""
    out = kernel_fn()
    ref = plain_fn()
    library = eager_blocks(blocks, stride)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and bool(torch.isfinite(out.float()).all()),
          f"{name}: kernel output bad")
    ulps = bf16_ulp_error(out, ref)
    abs_err = float((out.float() - ref.float()).abs().max())
    check(ulps <= BF16_ULPS * len(blocks), f"{name}: kernel disagrees by {ulps:.0f} ulps")
    lib_ulps = bf16_ulp_error(library(x), ref)
    before = counter()
    kernel_ms = cuda_ms(kernel_fn, 10)
    check(counter() - before == 11 * len(blocks), f"{name}: timing did not launch the kernel")
    plain_ms = cuda_ms(plain_fn, 3)
    library_ms = cuda_ms(lambda: library(x), 10)
    bound_ms, bound_by = blocks_bound_ms(tuple(x.shape), blocks, stride)
    print(f"{name} {tuple(x.shape)}: {ulps:.0f} ulps (abs {abs_err:.3g}; cuDNN form {lib_ulps:.0f}"
          f" ulps), kernel {kernel_ms:.3f} ms{'' if recorded_ms is None else f' (recorded: {recorded_ms:.3f})'}, "
          f"plain {plain_ms:.3f} ms, eager cuDNN "
          f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / kernel_ms:.1%} of bound")
    return dict(ulps=ulps, abs_err=abs_err, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_blocks_at_path_shapes(model, fused, batch) -> tuple[dict, dict]:
    """The bottleneck kernel on each stage's second (identity) block, and the
    stage op on each whole stage, at batch 128 on activations captured from
    the unfused path model, with the fused-eval model's folded weights.
    Returns the two kernels' entries, summed over the path: the 12 identity
    blocks of one batch for the bottleneck, the four stages for the stage op."""
    inputs = capture_stage_inputs(model, batch)
    per_block, per_stage = [], []
    for name, depth, stride in STAGES:
        layer = getattr(fused.backbone, name)
        x = inputs[(name, 1)]
        blk = layer[1].folded(torch.bfloat16)
        r = time_blocks(f"{name} identity block", x, [blk], 1,
                        lambda: fused_bottleneck(x, *blk), lambda: bottleneck_ref(x, *blk),
                        lambda: bottleneck.launches, RECORDED_BLOCK_MS[name])
        per_block.append((depth - 1, r))
        x0 = inputs[(name, 0)]
        blocks = [b.folded(torch.bfloat16) for b in layer]
        cm = blk[0].shape[1]
        print(f"  {name} tiles: identity {bottleneck.plan(*x.shape[:3], cm)}, first block "
              f"{bottleneck.plan(*x0.shape[:3], cm, stride, downsample=True)}")
        r = time_blocks(f"{name} stage", x0, blocks, stride,
                        lambda: fused_bottleneck_stage(x0, blocks, stride),
                        lambda: stage_ref(x0, blocks, stride),
                        lambda: bottleneck_stage.launches)
        per_stage.append((1, r))

    def total(rows):
        out = {k: sum(n * r[k] for n, r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms")}
        # bound_by: the kind of bound that makes up most of the summed bound.
        share = {kind: sum(n * r["bound_ms"] for n, r in rows if r["bound_by"] == kind)
                 for kind in ("bytes", "operations")}
        out.update(ulps=max(r["ulps"] for _, r in rows),
                   abs_err=max(r["abs_err"] for _, r in rows),
                   bound_by=max(share, key=share.get))
        return out

    rows = {"fused_bottleneck": total(per_block), "fused_bottleneck_stage": total(per_stage)}
    for op, r in rows.items():
        print(f"{op} per batch: kernel {r['ms']:.3f} ms (recorded: {RECORDED_BATCH_MS[op]:.3f}), eager "
              f"cuDNN {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of bound")
    return rows["fused_bottleneck"], rows["fused_bottleneck_stage"]


def fused_eval_path(fused, batches, feats, labels, counts) -> dict:
    """Path 2: the fused-eval extract, then its analytics, timed and checked
    against path 1's embeddings and labels. Returns the launch counts of the
    bottleneck kernel and of the stage op in the timed extract."""
    f2, _, _, _ = api.extract_features(fused, batches)  # warm-up: kernel load, fold cache
    api.cluster_groups(f2, **ANALYTICS)
    torch.cuda.synchronize()

    bottleneck.launches = bottleneck_stage.launches = 0
    t0 = time.perf_counter()
    f2, _, _, _ = api.extract_features(fused, batches)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = bottleneck.launches
    stage_launches = bottleneck_stage.launches
    t0 = time.perf_counter()
    labels2, counts2, epss2 = api.cluster_groups(f2, **ANALYTICS)
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    check(launches == 12 * len(batches),
          f"bottleneck kernel launched {launches} times in the timed fused-eval extract, "
          f"expected {12 * len(batches)} (12 identity blocks per batch)")
    cos = (f2 * feats).sum(-1) / (f2.norm(dim=-1) * feats.norm(dim=-1))
    cos_min = float(cos.min())
    agree = float((labels2 == labels).mean())
    same = same_cluster_share(labels2, labels)
    print(json.dumps({
        "path": "fused_eval",
        "fused_eval_extract_seconds": extract_s,
        "fused_eval_imgs_per_s": N / extract_s,
        "cluster_seconds_3groups": cluster_s,
        "clusters": counts2,
        "eps": epss2,
        "bottleneck_launches": launches,
        "min_cosine_vs_unfused": cos_min,
        "label_agreement_vs_unfused": agree,
        "same_cluster_share_vs_unfused": same,
    }))
    print(f"fused-eval: min per-row cosine to the unfused embeddings {cos_min:.6f}; labels "
          f"equal to path 1's on {agree:.4%} of points, same cluster on {same:.4%}; "
          f"clusters {counts2} vs {counts}")
    check(tuple(f2.shape) == (3, N, 2048), f"fused-eval features shape {tuple(f2.shape)}")
    check(bool(torch.isfinite(f2).all()), "non-finite fused-eval features")
    check(float((f2.norm(dim=-1) - 1).abs().max()) < 1e-3, "fused-eval embeddings not unit-norm")
    check(cos_min >= COSINE_MIN, f"fused-eval embeddings drift: min cosine {cos_min:.4f}")
    check_labels(labels2, counts2, epss2, "fused-eval")
    return {"fused_bottleneck": launches, "fused_bottleneck_stage": stage_launches}


def paired_extract_seconds(model, fused, batches, rounds: int = 2) -> dict:
    """Host-clock extract seconds of the unfused and the fused-eval model in
    turns (unfused, fused, fused, unfused, ...): host times spread between
    calls, so the two are compared only within one run."""
    times = {"unfused": [], "fused_eval": []}
    order = [("unfused", model), ("fused_eval", fused)]
    for _ in range(rounds):
        for name, m in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.extract_features(m, batches)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"paired extract (unfused, fused, fused, unfused x{rounds}): unfused "
          f"{[round(t, 4) for t in times['unfused']]} s, fused-eval "
          f"{[round(t, 4) for t in times['fused_eval']]} s; medians {med}")
    return med


def boundary_ties(original: torch.Tensor) -> int:
    """Rows of the re-ranking's normalised matrix with an exact tie across
    the end of a top-k prefix it uses (k2, k1/2 + 1, k1 + 1). Which of the
    tied neighbours is in the prefix is arbitrary (ops/topk.py), and the
    card's and the CPU's top-k choose differently."""
    orig = (original / original.amax(0).clamp_min(1e-12)).T
    srt = torch.sort(orig, 1).values
    ends = [K2, int(round(K1 / 2.0)) + 1, K1 + 1]
    return int(sum((srt[:, e - 1] == srt[:, e]).sum() for e in ends))


def check_same_matrix(feats, dist_impl: str, tie_aware: bool = False) -> None:
    """Against the port's CPU path (plain versions throughout) on a subset.

    Both re-rank the same squared-distance matrix (from ``dist_impl`` on the
    card): distances computed apart differ in the last bits, and among the
    near-tied neighbours of random-weight features that may swap a rank and
    so change V legitimately. Then both cluster the same re-ranked matrix:
    identical eps and labels. With ``tie_aware``, a group whose matrix has an
    exact tie at a top-k prefix end (``boundary_ties``) and whose re-ranked
    matrices differ is reported and not held to the same labels."""
    for g in range(3):
        original = pairwise_distance(feats[g, :400], impl=dist_impl)
        d_card = _re_ranking_impl(original, K1, K2, LAMBDA)
        d_cpu = _re_ranking_impl(original.cpu(), K1, K2, LAMBDA)
        gap = float((d_card.cpu() - d_cpu).abs().max())
        lab_card, n_card, eps_card = api.cluster(d_card, rho=0.02)
        lab_cpu, n_cpu, eps_cpu = api.cluster(d_card.cpu(), rho=0.02, device="cpu")
        print(f"subset group {g} N={original.shape[0]} (distance {dist_impl}): re-rank card vs "
              f"CPU max gap {gap:.2e}; {n_card} clusters, eps {eps_card:.6g} vs {eps_cpu:.6g}")
        if tie_aware and gap > 1e-5:
            ties = boundary_ties(original)
            print(f"  {ties} exact tie(s) at a top-k prefix end: the card and the CPU may "
                  "pick different neighbours, so this group is not compared")
            check(ties > 0, f"group {g}: re-ranked distances differ by {gap:.2e} with no tie")
            continue
        check(gap <= 1e-5, f"group {g}: re-ranked distances differ by {gap:.2e} on the subset")
        check(np.array_equal(lab_card, lab_cpu) and n_card == n_cpu
              and abs(eps_card - eps_cpu) <= 1e-6 * eps_cpu,
              f"group {g}: card and CPU cluster the same matrix differently")


def same_cluster_share(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points whose cluster (the set of points sharing its label;
    noise alone) is the same set under labelings ``a`` and ``b`` of each
    group. Unlike label equality it ignores renumbering: DBSCAN numbers
    clusters in discovery order, so one changed cluster renumbers the rest."""
    same = 0
    for la, lb in zip(a, b):
        n = la.shape[0]
        ua = np.where(la < 0, la.max() + 1 + np.arange(n), la)
        ub = np.where(lb < 0, lb.max() + 1 + np.arange(n), lb)
        _, ia, size_a = np.unique(ua, return_inverse=True, return_counts=True)
        _, ib, size_b = np.unique(ub, return_inverse=True, return_counts=True)
        _, ip, size_p = np.unique(ia.astype(np.int64) * (ib.max() + 1) + ib,
                                  return_inverse=True, return_counts=True)
        same += int(((size_p[ip] == size_a[ia]) & (size_p[ip] == size_b[ib])).sum())
    return same / a.size


def check_labels(labels, counts, epss, what: str) -> None:
    check(labels.shape == (3, N) and labels.dtype == np.int32, f"{what}: labels shape/type")
    for g in range(3):
        check(labels[g].min() >= -1 and labels[g].max() == counts[g] - 1,
              f"{what} group {g}: labels do not number {counts[g]} clusters")
        check(np.isfinite(epss[g]) and epss[g] > 0, f"{what} group {g}: eps {epss[g]}")
    check(sum(counts) > 0, f"{what}: no clusters found")


def exact_distance(x: torch.Tensor) -> torch.Tensor:
    """Squared distances from an fp64 product and fp64 norms, rounded once
    to fp32: the distance the fp32 contract (Precision.HIGHEST) aims at."""
    xd = x.double()
    sq = (xd * xd).sum(1)
    return (sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T)).clamp_min(0.0).float()


def analytics_labels(feats, dist_fn) -> np.ndarray:
    """cluster_groups' labels with each group's squared distances from ``dist_fn``."""
    out = []
    for g in range(feats.shape[0]):
        dist = _re_ranking_impl(dist_fn(feats[g]), K1, K2, LAMBDA)
        out.append(dbscan(dist, select_eps(dist, rho=RHO), min_samples=MIN_SAMPLES)[0])
    return torch.stack(out).cpu().numpy()


def distance_kernel_path(feats, labels, counts, epss) -> dict:
    """The CUDA distance kernel on each group's features against the plain
    version, then the analytics from it (dist_impl="kernel") checked against
    path 1's labels, then its times at that shape."""
    worst = worst_exact = 0.0
    for g in range(3):
        x = feats[g]
        out = pairwise_distance(x, impl="kernel")
        ref = pairwise_distance_ref(x)
        exact = exact_distance(x)
        torch.cuda.synchronize()
        check(torch.equal(out, out.T), f"distance kernel output not symmetric on group {g}")
        scale = 2.0 * float((x * x).sum(1).max())
        err = float((out - ref).abs().max())
        err_exact = float((out - exact).abs().max())
        worst, worst_exact = max(worst, err), max(worst_exact, err_exact)
        print(f"distance kernel on group {g}'s features: max abs err {err:.3e} (rel "
              f"{err / scale:.3e}); against exact distances {err_exact:.3e}, the plain "
              f"version (cuBLAS) {float((ref - exact).abs().max()):.3e}")
        check(err <= DIST_TOL * scale, f"distance kernel disagrees on group {g}'s features")

    distance.launches = 0
    labels3, counts3, epss3 = api.cluster_groups(feats, **ANALYTICS, dist_impl="kernel")
    launches = distance.launches
    check(launches == 3, f"distance kernel launched {launches} times in cluster_groups, "
                         "expected 3 (one per group)")
    agree = float((labels3 == labels).mean())
    same = same_cluster_share(labels3, labels)
    exact = analytics_labels(feats, exact_distance)
    same_exact = same_cluster_share(labels3, exact)
    path1_exact = same_cluster_share(labels, exact)
    print(f"distance-kernel analytics: labels equal to path 1's on {agree:.6f} of points, "
          f"same cluster on {same:.6f}; clusters {counts3} vs {counts}, eps {epss3} vs {epss}; "
          f"same cluster as from exact distances on {same_exact:.6f} (path 1: {path1_exact:.6f})")
    check_labels(labels3, counts3, epss3, "distance-kernel analytics")
    # Labels from fp32 distances are not held to one another at 99.9 %: two
    # matrices that differ in the last bits swap near-tied neighbours of the
    # random-weight features and so change V (ROADMAP C). The reference is
    # the analytics on exact distances (fp64, rounded once), since cuBLAS's
    # matrix, path 1's, is itself ~1 % of points away from it. Gated: the
    # kernel's matrix against the plain one (above), the analytics on the
    # kernel's matrix against the CPU on the same matrix, and 99 % of points
    # in the same cluster as from exact distances.
    check(same_exact >= 0.99, f"distance-kernel analytics: only {same_exact:.4%} of points in "
                              "the same cluster as from exact distances")
    check_same_matrix(feats, "kernel", tie_aware=True)

    x = feats[0]
    kernel_ms = cuda_ms(lambda: pairwise_distance(x, impl="kernel"), 20)
    plain_ms = cuda_ms(lambda: pairwise_distance_ref(x), 20)
    library_ms = cuda_ms(lambda: torch.cdist(x, x).square_(), 20)
    n, d = x.shape
    # The call is symmetric; its bound is the 3xTF32 route's, the least time
    # for fp32-accurate distances. The FMA bounds keep earlier rows comparable.
    bound_ms, bound_by = dist_bound_ms(n, n, d, symmetric=True, route="3xtf32")
    fma_sym_ms = dist_bound_ms(n, n, d, symmetric=True)[0]
    fma_dense_ms = dist_bound_ms(n, n, d)[0]
    print(f"distance at ({N},{d})^2: kernel {kernel_ms:.3f} ms, plain (= impl auto, "
          f"cuBLAS) {plain_ms:.3f} ms, torch.cdist squared {library_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}, 3xTF32, symmetric), {bound_ms / kernel_ms:.1%} of "
          f"bound; FMA bounds {fma_sym_ms:.3f} ms symmetric, {fma_dense_ms:.3f} ms dense; "
          f"max abs err {worst:.3e}")
    return dict(launches=launches, abs_err=worst, rel=worst / (2.0 * float((x * x).sum(1).max())),
                same_cluster_vs_exact=same_exact, same_cluster_vs_path1=same,
                abs_err_vs_exact=worst_exact,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, fma_sym_ms=fma_sym_ms, fma_dense_ms=fma_dense_ms)


def check_operand_conversion(dev: torch.device) -> None:
    """The all-pairs wrappers take operands as JAX does: a strided view and a
    bf16 one are converted to contiguous fp32 once, a view against itself is
    still the symmetric launch (exactly symmetric output), and the result
    equals the kernel on the converted operand."""
    gen = torch.Generator(device=dev).manual_seed(3)
    strided = torch.randn((700, 260), generator=gen, device=dev)[::2, 1::2]  # (350, 130)
    calls = (("l1_distance", l1, lambda a: l1.l1_distance(a)),
             ("pairwise_distance", distance, lambda a: pairwise_distance(a, impl="kernel")))
    for name, mod, fn in calls:
        for label, x in (("strided", strided), ("bf16 strided", strided.to(torch.bfloat16))):
            before = mod.launches
            out = fn(x)
            ref = fn(x.float().contiguous())
            torch.cuda.synchronize()
            check(mod.launches - before == 2, f"{name} {label}: kernel not launched")
            check(torch.equal(out, out.T), f"{name} {label}: the symmetric launch was lost")
            check(torch.equal(out, ref), f"{name} {label}: differs from the converted operand")
            print(f"{name} on a {label} {tuple(x.shape)} operand: converted, symmetric, "
                  "equal to the contiguous fp32 call")


# Path 3, fine-tuning at full width: ResNet-50 on 256x128 crops, 3 parts.
TRAIN_H, TRAIN_W = 256, 128
T1_LOSS_REL = 1e-4  # fp32 card step against the CPU: sums in another order
T1_GRAD_REL = 1e-3  # of a tensor's largest |g|, beside twice the CPU's own error
# T3: the random-weight features form a few dozen whole-body clusters of the
# 1120 images whatever rho, 1-2 P x K batches of 64 an epoch, so rho cannot
# buy 10 steps in one epoch. SSG's own rho keeps both iterations above the
# 16 clusters a batch of 64 needs (after the first iteration's training a
# larger rho merges them below that); 10 epochs give iteration 0 10 steps.
T3_RHO = 1.6e-3
T3_EPOCHS = 10


def pk_batch(ds, p: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K rendered images of each of the first P train identities, uint8 on
    the host, and their labels (3, P K), the same for every part."""
    by_pid = {}
    for fname, pid, _ in ds.train:
        by_pid.setdefault(pid, []).append(fname)
    pids = sorted(by_pid)[:p]
    images = torch.from_numpy(ds.render([f for pid in pids for f in by_pid[pid][:k]]))
    return images, torch.arange(p).repeat_interleave(k)[None].repeat(3, 1)


def forward_flops(model, x: torch.Tensor) -> float:
    """Operations of one forward of ``model`` on ``x``, from its convolution
    and linear shapes (2 per multiply-add)."""
    total = 0.0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total += 2.0 * out.numel() * mod.in_channels // mod.groups * kh * kw
        else:
            total += 2.0 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    return total


def t1_step_parity(dev: torch.device, ds) -> dict:
    """T1: one fp32 train step of ResNet-50 at full width (dropout 0, batch 8
    = P 2 x K 4, 256x128, the same crops and flips from one ``draw_crops``)
    on the card and on the CPU from the same weights: the loss, and every
    parameter's gradient against the same step in fp64.

    At random initialisation, with BatchNorm normalising 8 images, the
    network amplifies fp32 rounding by orders of magnitude in the gradients,
    so two correct fp32 steps do not agree to 1e-3 of a tensor's largest
    gradient. The yardstick is the CPU's own fp32 error against fp64: the
    card's worst error over all tensors must stay within twice the CPU's
    worst (plus 1e-3), so a card step that computed something else, or in
    TF32, fails."""
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(1))
    exact = copy.deepcopy(model).double()
    exact.dtype = torch.float64
    on_cpu = copy.deepcopy(model)
    images, labels = pk_batch(ds, 2, 4)
    boxes, flips = transforms.draw_crops(torch.Generator(device=dev).manual_seed(1), 8,
                                         *images.shape[1:3])
    out = {}
    for name, m, d in (("card", model, dev), ("cpu", on_cpu, torch.device("cpu")),
                       ("fp64", exact, dev)):
        m.to(d, memory_format=torch.channels_last)
        step = make_train_step(m, make_optimizer(m.parameters(), 6e-5), num_parts=3,
                               height=TRAIN_H, width=TRAIN_W)
        t0 = time.perf_counter()
        metrics = step(images.to(d), labels.to(d), crops=(boxes.to(d), flips.to(d)))
        loss = float(metrics["loss"])
        out[name] = (loss, {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()},
                     time.perf_counter() - t0)
    (loss_card, g_card, s_card), (loss_cpu, g_cpu, s_cpu), (loss_64, g_64, _) = (
        out["card"], out["cpu"], out["fp64"])
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    # The triplet loss does not move when every embedding shifts alike, so
    # the part BNs' bias gradients are 0 up to rounding: every tensor's
    # scale is floored at 1e-3 of the largest gradient.
    floor = 1e-3 * max(float(g.abs().max()) for g in g_64.values())

    def errors(g):
        return {k: float((g[k] - ref).abs().max()) / max(float(ref.abs().max()), floor)
                for k, ref in g_64.items()}

    err_card, err_cpu, card_cpu = errors(g_card), errors(g_cpu), {
        k: float((g_card[k] - g).abs().max()) / max(float(g.abs().max()), floor)
        for k, g in g_cpu.items()}
    worst = {name: max(e.items(), key=lambda kv: kv[1])
             for name, e in (("card", err_card), ("cpu", err_cpu), ("card_vs_cpu", card_cpu))}
    print(f"T1 fp32 step, ResNet-50 batch 8 at 256x128: loss card {loss_card:.7f}, cpu "
          f"{loss_cpu:.7f} (rel {loss_rel:.2e}), fp64 {loss_64:.7f}; worst gradient error of "
          f"a tensor's max |g| ({len(g_64)} tensors): card against fp64 {worst['card'][1]:.3e} "
          f"({worst['card'][0]}), CPU against fp64 {worst['cpu'][1]:.3e} ({worst['cpu'][0]}), "
          f"card against CPU {worst['card_vs_cpu'][1]:.3e} ({worst['card_vs_cpu'][0]}); step "
          f"{s_card:.2f} s card (first, cold), {s_cpu:.2f} s CPU")
    check(np.isfinite(loss_card) and loss_rel <= T1_LOSS_REL,
          f"T1: the card's loss {loss_card} is not the CPU's {loss_cpu}")
    # Over all tensors: which tensor is worst, and by how much, varies from
    # one correct fp32 step to another.
    check(worst["card"][1] <= 2.0 * worst["cpu"][1] + T1_GRAD_REL,
          f"T1: the card's gradients are {worst['card'][1]:.2e} from fp64 "
          f"({worst['card'][0]}), the CPU's {worst['cpu'][1]:.2e}")
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_fp64": loss_64,
            "loss_rel": loss_rel, "worst_grad_err_card": worst["card"][1],
            "worst_grad_err_cpu": worst["cpu"][1], "worst_grad_card_vs_cpu": worst["card_vs_cpu"][1]}


def t2_train_step(dev: torch.device, ds, arch: str = "resnet50") -> dict:
    """T2: the bf16 train step (fp32 masters) of ``arch`` (ResNet-50; path 6
    also times the Inception) at batch 64 = P 16 x K 4, 3 parts, on a
    repeated batch already on the card: 5 warm-up and 20 timed steps, each
    between CUDA events; the loss must fall. One more step runs under
    ``profiling.trace`` to count its device events (kernels and copies)."""
    model = models.create(arch, num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev, memory_format=torch.channels_last)
    images, labels = pk_batch(ds, 16, 4)
    images, labels = images.to(dev), labels.to(dev)
    flop = 3.0 * forward_flops(model, transforms.test_transform(images))  # forward + backward
    # lr 1e-3 as the JAX package's own learning-signal test; the time of a
    # step does not depend on it.
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3), num_parts=3,
                           height=TRAIN_H, width=TRAIN_W)
    gen = torch.Generator(device=dev).manual_seed(2)
    losses = [step(images, labels, gen)["loss"] for _ in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(20)]
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        losses.append(step(images, labels, gen)["loss"])
        end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(events)
    device_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory(prefix="ssg_t2_trace_") as logdir:
        with profiling.trace(logdir):
            step(images, labels, gen)
        with contextlib.redirect_stdout(io.StringIO()):
            trace = traceview.report_by_scope(logdir)
    events, busy_ms = trace["device_events"], trace["total_us"] / 1e3
    losses = [float(x) for x in losses]
    share = flop / (device_ms * 1e-3) / BF16_FLOP_PER_S
    r = {"arch": arch, "train_step_ms": device_ms, "device_events_per_step": events,
         "device_busy_ms_per_step": busy_ms, "host_ms_per_step": host_ms,
         "imgs_per_s": 64 / (host_ms * 1e-3), "peak_gib": peak_gib, "tflop_per_step": flop / 1e12,
         "bf16_peak_share": share, "bound_ms": flop / BF16_FLOP_PER_S * 1e3,
         "loss_first5": float(np.mean(losses[:5])), "loss_last5": float(np.mean(losses[-5:]))}
    print(f"T2 bf16 step, {arch} batch 64 (P 16 x K 4) at 256x128: median {device_ms:.3f} ms "
          f"on the card (CUDA events), {host_ms:.3f} ms on the host clock, "
          f"{r['imgs_per_s']:.0f} img/s, peak {peak_gib:.2f} GiB; a traced step: {events} device "
          f"events, {busy_ms:.3f} ms of them; "
          f"{flop / 1e12:.3f} TFLOP a step (3 x forward), {share:.1%} of the bf16 dense peak "
          f"(bound {r['bound_ms']:.3f} ms); loss {r['loss_first5']:.4f} -> "
          f"{r['loss_last5']:.4f} (first and last 5 of 25)")
    check(all(np.isfinite(losses)), "T2: non-finite loss")
    check(r["loss_last5"] < r["loss_first5"], "T2: the loss did not fall on a repeated batch")
    return r


def t3_run_ssg(dev: torch.device) -> dict:
    """T3: ``api.train`` for two SSG iterations (the second resumed from the
    first's checkpoint) of the bf16 ResNet-50 from seeded random weights on
    synthetic DukeMTMC at scale 0.2, batch 64, K 4, evaluation every
    iteration."""
    tgt = datasets.create("dukemtmc", scale=0.2, seed=0)
    check((len(tgt.train), len(tgt.query), len(tgt.gallery)) == (1120, 280, 560),
          "T3: unexpected dataset size")
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    logs = tempfile.mkdtemp(prefix="ssg_t3_")
    ckpt = os.path.join(logs, "checkpoint.pth")
    kw = dict(epochs=T3_EPOCHS, batch_size=64, num_instances=4, rho=T3_RHO, logs_dir=logs,
              print_freq=10)
    step_losses = []

    class Probe:
        def metric(self, **kv):
            if kv.get("kind") == "train_step":
                step_losses.append(kv["loss"])

    history, launches = [], []
    optimizer = None
    for iterations, resume in ((1, None), (2, ckpt)):
        l1.launches = 0
        optimizer, hist = api.train(model, tgt, SSGConfig(iterations=iterations, **kw),
                                    logger=Probe(), resume_from=resume)
        launches.append(l1.launches)
        history += hist
    check([h["iteration"] for h in history] == [0, 1], f"T3: iterations run "
          f"{[h['iteration'] for h in history]}, expected [0, 1] (the second resumed)")
    rows = []
    for h, n_l1 in zip(history, launches):
        row = {"iteration": h["iteration"], "clusters": [c for c, _ in h["clusters"]],
               "eps": [e for _, e in h["clusters"]], "kept": h["kept"], "steps": h["steps"],
               "loss": h["loss"], "mAP": h["mAP"], "rank1": h["rank1"], "l1_launches": n_l1}
        row.update({k: h[k] for k in ("extract_seconds", "cluster_seconds", "train_seconds",
                                      "eval_seconds")})
        rows.append(row)
        print(f"T3 iteration {h['iteration']}: clusters {row['clusters']}, eps "
              f"{[round(e, 4) for e in row['eps']]}, kept {h['kept']}/1120, {h['steps']} steps, "
              f"mean loss {h['loss']:.4f}, mAP {h['mAP']:.4f}, rank-1 {h['rank1']:.4f}; seconds: "
              f"extract {h['extract_seconds']:.2f}, cluster {h['cluster_seconds']:.3f}, train "
              f"{h['train_seconds']:.2f}, eval {h['eval_seconds']:.2f}; L1 kernel launches {n_l1}")
    check(all(np.isfinite(step_losses)) and len(step_losses) == sum(r["steps"] for r in rows),
          "T3: non-finite or missing step losses")
    check(rows[0]["steps"] >= 10 and rows[1]["steps"] >= 1,
          f"T3: steps {[r['steps'] for r in rows]}; iteration 0 needs 10 and each must train")
    check(launches == [3, 3], f"T3: L1 kernel launches {launches}, expected 3 an iteration")
    # The optimizer carried iteration 0's state into iteration 1.
    counts = {float(st["step"]) for st in optimizer.state.values()}
    check(counts == {float(rows[0]["steps"] + rows[1]["steps"])},
          f"T3: AdamW step counts {counts} after resuming, expected "
          f"{rows[0]['steps'] + rows[1]['steps']}")
    # The checkpoint, reloaded onto the card, gives the same eval embeddings.
    fresh = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    fresh.load_state_dict(load_checkpoint(ckpt, device=dev)["model"])
    fresh.to(dev, memory_format=torch.channels_last)
    batches = [(torch.from_numpy(im).to(dev), p, c, m)
               for im, p, c, m in Preprocessor(tgt, items=tgt.query, batch_size=64)]
    a = api.extract_features(model, batches)[0]
    b = api.extract_features(fresh, batches)[0]
    check(torch.equal(a, b), "T3: the reloaded checkpoint's embeddings differ")
    print(f"T3: checkpoint reloaded onto the card gives the same {tuple(a.shape)} embeddings bit "
          f"for bit; AdamW resumed at step {rows[0]['steps']} (ran to "
          f"{rows[0]['steps'] + rows[1]['steps']}); rho {T3_RHO}, {T3_EPOCHS} epochs")
    for name in ("checkpoint.pth", "model_best.pth"):
        if os.path.exists(os.path.join(logs, name)):
            os.remove(os.path.join(logs, name))
    os.rmdir(logs)
    return {"rho": T3_RHO, "epochs": T3_EPOCHS, "iterations": rows}


def train_phases(dev: torch.device) -> dict:
    """Path 3: T1, T2 and T3 (``t1_step_parity``, ``t2_train_step``,
    ``t3_run_ssg``)."""
    ds = datasets.create("dukemtmc", scale=0.2, seed=0)
    t0 = time.perf_counter()
    t1 = t1_step_parity(dev, ds)
    t2 = t2_train_step(dev, ds)
    t3 = t3_run_ssg(dev)
    return {"t1": t1, "t2": t2, "t3": t3, "seconds": time.perf_counter() - t0}


# Path 4: the command-line workflow, through the CLIs' main(argv).
CLI_MODEL = ["--arch", "resnet50", "--num_features", "0", "--batch_size", "64",
             "--num_instances", "4", "--dtype", "bfloat16", "--seed", "0", "--print_freq", "10"]
# P1/P2's source (600 images of 75 identities) and P1's evaluation target;
# P3/P4's target (1120 train images of 140 identities, 280 + 560 to evaluate).
CLI_SOURCE_SCALE = "0.1"
CLI_TARGET_SCALE = "0.2"
LUT_NORM_TOL = 1e-5
REMAT_REL = 1e-3  # remat against the plain step: losses and BN statistics, bf16 kernels
METRICS_TOL = 1e-6  # allshots CMC and mAP, card against CPU: fp32 sums in another order


def run_cli(name: str, main_fn, argv: list[str], logs: str) -> dict:
    """One CLI run in this process, with the L1 kernel's count set to 0
    just before and read just after; its structured log read back."""
    l1.launches = 0
    t0 = time.perf_counter()
    rc = main_fn(argv + ["--logs_dir", logs])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{name}: exit code {rc}")
    with open(os.path.join(logs, "log.txt.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return {"metrics": metrics, "l1_launches": l1.launches, "seconds": seconds}


def of_kind(run: dict, kind: str) -> list[dict]:
    return [m for m in run["metrics"] if m["kind"] == kind]


def p1_p2_pretraining(root: str) -> tuple[dict, dict, str]:
    """P1: softmax + triplet pretraining on synthetic Market-1501 at scale
    0.1, 2 epochs, evaluated on DukeMTMC. P2: the same with OIM, 1 epoch;
    its table's touched rows must be unit rows and the others still 0."""
    base = CLI_MODEL + ["--dataset", "market1501", "--scale", CLI_SOURCE_SCALE]
    p1 = run_cli("P1", pretraining.main, base + ["--epochs", "2", "--evaluate_on", "dukemtmc"],
                 os.path.join(root, "p1"))
    epochs = of_kind(p1, "pretrain_epoch")
    (ev,), (secs,) = of_kind(p1, "eval"), of_kind(p1, "seconds")
    check(len(epochs) == 2 and all(e["steps"] > 0 and np.isfinite(e["loss"]) for e in epochs),
          f"P1: epochs {epochs}")
    check(0.0 <= ev["mAP"] <= 1.0 and 0.0 <= ev["rank1"] <= 1.0, f"P1: evaluation {ev}")
    ckpt_path = os.path.join(root, "p1", "source_checkpoint.pth")
    ckpt = load_checkpoint(ckpt_path, device="cpu")
    check(tuple(ckpt["model"]["classifier_whole.weight"].shape) == (75, 2048),
          "P1: the classifier is not sized to the 75 source identities")
    r1 = {"losses": [e["loss"] for e in epochs], "steps": [e["steps"] for e in epochs],
          "lrs": sorted({r for e in epochs for r in e["lrs"]}), "mAP": ev["mAP"],
          "rank1": ev["rank1"], "train_seconds": secs["train"], "eval_seconds": secs["eval"],
          "epoch_seconds": [e["seconds"] for e in epochs], "seconds": p1["seconds"],
          "l1_launches": p1["l1_launches"]}
    print(f"P1 pretraining (softmax + triplet, Market-1501 x{CLI_SOURCE_SCALE}, 2 epochs): loss "
          f"per epoch {[round(x, 4) for x in r1['losses']]}, steps {r1['steps']}, DukeMTMC "
          f"mAP {ev['mAP']:.4f} rank-1 {ev['rank1']:.4f}; seconds: train {secs['train']:.2f} "
          f"(epochs {[round(x, 2) for x in r1['epoch_seconds']]}), eval {secs['eval']:.2f}")

    p2 = run_cli("P2", pretraining.main, base + ["--epochs", "1", "--loss", "oim"],
                 os.path.join(root, "p2"))
    (epoch,) = of_kind(p2, "pretrain_epoch")
    lut = load_checkpoint(os.path.join(root, "p2", "source_checkpoint.pth"), device="cpu")["lut"]
    norms = lut.double().norm(dim=1)
    touched = norms > 0
    worst = float((norms[touched] - 1).abs().max()) if bool(touched.any()) else float("inf")
    check(np.isfinite(epoch["loss"]) and epoch["steps"] > 0, f"P2: epoch {epoch}")
    check(tuple(lut.shape) == (75, 2048), f"P2: table shape {tuple(lut.shape)}")
    check(worst <= LUT_NORM_TOL, f"P2: touched rows' norms off 1 by {worst:.2e}")
    check(not bool(lut[~touched].any()), "P2: an untouched row is not 0")
    r2 = {"loss": epoch["loss"], "steps": epoch["steps"], "touched_rows": int(touched.sum()),
          "worst_norm_err": worst, "seconds": p2["seconds"], "l1_launches": p2["l1_launches"]}
    print(f"P2 pretraining (OIM + triplet, 1 epoch): loss {epoch['loss']:.4f}, {epoch['steps']} "
          f"steps, {r2['touched_rows']}/75 table rows touched (norms within {worst:.2e} of 1, "
          f"the rest 0); {p2['seconds']:.2f} s")
    return r1, r2, ckpt_path


def ssg_cli(name: str, main_fn, argv: list[str], logs: str, launches: int) -> dict:
    """P3/P4: one SSG iteration through a CLI; it must train, evaluate and
    launch the L1 kernel ``launches`` times."""
    run = run_cli(name, main_fn, argv, logs)
    its = of_kind(run, "iteration")
    check(len(its) == 1 and its[0]["steps"] > 0 and "mAP" in its[0],
          f"{name}: the iteration did not train and evaluate ({its})")
    check(run["l1_launches"] == launches,
          f"{name}: L1 kernel launches {run['l1_launches']}, expected {launches}")
    (it,) = its
    r = {k: it[k] for k in ("kept", "steps", "loss", "mAP", "rank1", "extract_seconds",
                            "cluster_seconds", "train_seconds", "eval_seconds")}
    r.update(clusters=[c for c, _ in it["clusters"]], seconds=run["seconds"],
             l1_launches=run["l1_launches"])
    print(f"{name}: clusters {r['clusters']}, kept {it['kept']}/1120, {it['steps']} steps, mean "
          f"loss {it['loss']:.4f}, mAP {it['mAP']:.4f}, rank-1 {it['rank1']:.4f}; seconds: "
          f"extract {it['extract_seconds']:.2f}, cluster {it['cluster_seconds']:.3f}, train "
          f"{it['train_seconds']:.2f}, eval {it['eval_seconds']:.2f}, all {run['seconds']:.2f}; "
          f"L1 kernel launches {run['l1_launches']}")
    return r


def p5_remat(dev: torch.device, ds, arch: str = "resnet50") -> dict:
    """P5: the bf16 step of ``arch`` (ResNet-50; path 6 also runs the
    Inception) at batch 64 (P 16 x K 4) on one batch
    with fixed crops, with and without remat, from the same weights, in
    turns: 5 steps compared (loss, BN statistics, and the parameters, which
    the gradients moved), then 10 timed each (CUDA
    events). Peak memory is read per step, with both models and what earlier
    phases hold resident, and also as the step's rise over the memory
    allocated before it (activations, gradients, workspaces)."""
    images, labels = pk_batch(ds, 16, 4)
    images, labels = images.to(dev), labels.to(dev)
    crops = transforms.draw_crops(torch.Generator(device=dev).manual_seed(3), 64, TRAIN_H,
                                  TRAIN_W)
    plain = models.create(arch, num_features=0, num_parts=3, dtype=torch.bfloat16)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    remat = copy.deepcopy(plain)
    steps = {}
    for name, m in (("plain", plain), ("remat", remat)):
        m.to(dev, memory_format=torch.channels_last)
        steps[name] = make_train_step(m, make_optimizer(m.parameters(), 6e-5), num_parts=3,
                                      height=TRAIN_H, width=TRAIN_W, remat=name == "remat")
    losses = {"plain": [], "remat": []}
    ms = {"plain": [], "remat": []}
    peak = {"plain": [], "remat": []}
    rise = {"plain": [], "remat": []}
    stat_err = None
    for i in range(15):
        for name in (("plain", "remat") if i % 2 == 0 else ("remat", "plain")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = steps[name](images, labels, crops=crops)
            end.record()
            torch.cuda.synchronize()
            peak[name].append(torch.cuda.max_memory_allocated() / 2**30)
            rise[name].append((torch.cuda.max_memory_allocated() - before) / 2**30)
            losses[name].append(float(out["loss"]))
            if i >= 5:
                ms[name].append(start.elapsed_time(end))
        if i == 4:
            rel = {k: float((a.double() - b.double()).abs().max())
                   / max(float(a.double().abs().max()), 1e-12)
                   for (k, a), b in zip(plain.state_dict().items(), remat.state_dict().values())}
            stat_err = max(v for k, v in rel.items() if "running" in k)
            param_err = max(rel[k] for k, _ in plain.named_parameters())
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(losses["plain"][:5], losses["remat"][:5]))
    r = {"peak_gib": {k: max(v[1:]) for k, v in peak.items()},
         "step_rise_gib": {k: max(v[1:]) for k, v in rise.items()},
         "median_ms": {k: statistics.median(v) for k, v in ms.items()},
         "loss_rel_err_5_steps": loss_err, "bn_stats_rel_err_5_steps": stat_err,
         "params_rel_err_5_steps": param_err,
         "losses_5": {k: v[:5] for k, v in losses.items()},
         "model_gib": torch.cuda.memory_allocated() / 2**30}
    r["slowdown"] = r["median_ms"]["remat"] / r["median_ms"]["plain"]
    print(f"P5 remat, bf16 {arch} batch 64: peak {r['peak_gib']['plain']:.3f} GiB plain, "
          f"{r['peak_gib']['remat']:.3f} GiB remat ({r['model_gib']:.3f} GiB resident after the "
          f"steps); a step's rise {r['step_rise_gib']['plain']:.3f} GiB plain, "
          f"{r['step_rise_gib']['remat']:.3f} GiB remat; median {r['median_ms']['plain']:.3f} "
          f"ms plain, {r['median_ms']['remat']:.3f} ms remat ({r['slowdown']:.3f}x, 10 steps "
          f"each in turns, CUDA events); over 5 steps "
          f"losses within {loss_err:.2e} relative, BN statistics within {stat_err:.2e}, "
          f"parameters within {param_err:.2e} of each tensor's largest")
    check(loss_err <= REMAT_REL, f"P5: remat's losses differ by {loss_err:.2e}")
    check(stat_err <= REMAT_REL, f"P5: remat's BN statistics differ by {stat_err:.2e}")
    check(r["peak_gib"]["remat"] < r["peak_gib"]["plain"],
          f"P5: remat's peak {r['peak_gib']['remat']:.3f} GiB is not below the plain step's "
          f"{r['peak_gib']['plain']:.3f}")
    return r


def p6_metrics(dev: torch.device) -> dict:
    """P6: ``evaluation_metrics`` on the card against the same calls on the
    CPU. A seeded protocol (1000 queries against 4000 gallery images of 200
    identities on 6 cameras, quantised distances with many ties): ``cmc``
    in the four combinations of ``separate_camera_set`` x
    ``first_match_break`` at topk 150 (first match exact, allshots within
    1e-6), ``mean_ap`` within 1e-6, ``accuracy`` on tied integer logits
    exactly. ``single_gallery_shot``: exact on a gallery with one valid
    image an identity (there the draw decides nothing), and on the random
    protocol finite, nondecreasing and in range (the card's draws are not
    the CPU's)."""
    rng = np.random.default_rng(7)
    nq, ng, ids, cams = 1000, 4000, 200, 6
    q_ids, g_ids = rng.integers(0, ids, nq), rng.integers(0, ids, ng)
    q_cams, g_cams = rng.integers(0, cams, nq), rng.integers(0, cams, ng)
    dist = (rng.integers(0, 64, (nq, ng)) / 8.0).astype(np.float32)
    dist -= 2.0 * (q_ids[:, None] == g_ids[None, :])
    args = (dist, q_ids, g_ids, q_cams, g_cams)
    t0 = time.perf_counter()
    errs = {}
    for sep in (False, True):
        for fmb in (False, True):
            kw = dict(topk=150, separate_camera_set=sep, first_match_break=fmb)
            card, cpu = cmc(*args, device=dev, **kw), cmc(*args, device="cpu", **kw)
            name = f"cmc separate_camera_set={sep} first_match_break={fmb}"
            check(card.shape == (150,) and bool(np.isfinite(card).all()), f"P6: {name} shape")
            errs[name] = float(np.abs(card - cpu).max())
            check(errs[name] <= (0.0 if fmb else METRICS_TOL),
                  f"P6: {name} differs from the CPU by {errs[name]:.2e}")
    errs["mean_ap"] = abs(mean_ap(*args, device=dev) - mean_ap(*args, device="cpu"))
    check(errs["mean_ap"] <= METRICS_TOL, f"P6: mean_ap differs by {errs['mean_ap']:.2e}")
    logits = rng.integers(0, 3, (512, 100)).astype(np.float32)
    target = rng.integers(0, 100, 512)
    acc = accuracy(logits, target, topk=(1, 5), device=dev)
    check(acc == accuracy(logits, target, topk=(1, 5), device="cpu"), f"P6: accuracy {acc}")
    # One valid gallery image an identity (cameras differ from the queries').
    single = (rng.normal(size=(2 * ids, ids)).astype(np.float32), np.arange(ids).repeat(2),
              np.arange(ids), np.zeros(2 * ids, int), np.ones(ids, int))
    for sep in (False, True):
        for fmb in (False, True):
            kw = dict(topk=150, single_gallery_shot=True, separate_camera_set=sep,
                      first_match_break=fmb)
            card = cmc(*single, device=dev, **kw)
            check(np.array_equal(card, cmc(*single, device="cpu", **kw)),
                  f"P6: single_gallery_shot (sep={sep}, fmb={fmb}) differs from the CPU")
            card = cmc(*args, rng=np.random.default_rng(0), device=dev, **kw)
            top = 10.0 if fmb else 1.0  # the oracle's x repeats quirk
            check(bool(np.isfinite(card).all()) and bool((np.diff(card) >= 0).all())
                  and card[0] >= 0.0 and card[-1] <= top * (1 + 1e-6),
                  f"P6: single_gallery_shot (sep={sep}, fmb={fmb}) on the card: {card[:5]}")
    r = {"max_err": errs, "accuracy": acc, "seconds": time.perf_counter() - t0}
    print(f"P6 metrics on the card against the CPU ({nq} x {ng}, ties): worst "
          f"{max(errs.values()):.2e} ({', '.join(f'{k} {v:.2e}' for k, v in errs.items())}); "
          f"accuracy {acc} equal; single_gallery_shot exact where the draw decides nothing, in "
          f"range elsewhere; {r['seconds']:.2f} s")
    return r


def cli_phases(dev: torch.device, root: str) -> dict:
    """Path 4: P1-P4 through the CLIs in this process, each in a log
    directory of its own under ``root`` (P1's checkpoint stays there for
    path 6), then P5 (remat) and P6 (the evaluation metrics on the card)."""
    t0 = time.perf_counter()
    p1, p2, source = p1_p2_pretraining(root)
    target = CLI_MODEL + ["--tgt_dataset", "dukemtmc", "--scale", CLI_TARGET_SCALE,
                          "--iteration", "1", "--resume", source]
    # 3 launches in cluster_groups, 1 in the re-ranked evaluation.
    p3 = ssg_cli("P3 selftraining", selftraining.main,
                 target + ["--epochs", "2", "--rho", "1.6e-3", "--rerank"],
                 os.path.join(root, "p3"), launches=4)
    p4 = ssg_cli("P4 semitraining", semitraining.main, target + ["--epochs", "1"],
                 os.path.join(root, "p4"), launches=3)
    heads = load_checkpoint(os.path.join(root, "p4", "checkpoint.pth"),
                            device="cpu")["model"]["classifier_whole.weight"]
    check(tuple(heads.shape) == (140, 2048),
          f"P4: classifier {tuple(heads.shape)}, expected the 140 target identities")
    p5 = p5_remat(dev, datasets.create("dukemtmc", scale=0.2, seed=0))
    p6 = p6_metrics(dev)
    return {"p1": p1, "p2": p2, "p3": p3, "p4": p4, "p5": p5, "p6": p6,
            "seconds": time.perf_counter() - t0}


# Path 5, large N: seeded clustered features at full width, at the standard
# split sizes: evaluation over Evaluator's concat embedding (3 x 2048 = 6144),
# clustering over the 2048-d part groups.
STREAM_CHUNK = 512  # streaming's default chunk
E1_Q, E1_G, E1_IDS, E1_CAMS = 3368, 15913, 751, 6  # Market-1501 test split
C1_N, C1_IDS, C1_GROUPS = 16522, 702, 3  # DukeMTMC-reID train split
C2_N, C2_IDS = 32621, 1041  # MSMT17 train split
FEAT_NOISE = 0.3  # as tests/test_streaming.py::_feats
# Identity centres are a normal draw in a low-dimensional subspace, scaled
# to the full width. That is an assumption about re-id embeddings, not a
# measured property of them. Drawn in 2048 independent directions, the
# centres put every pair of identities at one distance; the eps quantile
# then falls in that wall of equal cross-identity distances, and no group
# takes the fast path (code 27, scripts/torch_streaming_features.py), so
# the fast-path gate could not hold. Clustering takes 32 directions, the
# geometry PERF.md's path-5 prediction assumed; fewer directions
# separate identities more and make the fast path more likely (16 is the
# best case that script measured). Evaluation takes 8 directions, so that a
# few identities are close enough to confuse rank-1 (~1 %). The train
# splits' images per identity are long-tailed: log-normal identity weights
# with sigma TRAIN_SKEW; the test split's query and gallery images are
# spread evenly (sigma 0), as the protocol's ~21 gallery images an identity
# are. Features come identity-ordered, as an extract emits them.
EVAL_LATENT, CLUSTER_LATENT = 8, 32
TRAIN_SKEW = 0.8
E1_MAP_TOL = 1e-4  # streaming against dense re-ranked evaluation: summation order
E1_ROWS_TOL = 1e-5  # the re-ranked rows E1 ranks against the dense matrix's
SAME_CLUSTER_MIN = 0.999  # as path 1's gate
EPS_REL = 1e-5


def identities(gen: torch.Generator, n: int, ids: int, skew: float, dev) -> torch.Tensor:
    """Identity of each of ``n`` images (log-normal identity weights with
    sigma ``skew``), sorted."""
    w = torch.exp(skew * torch.randn(ids, generator=gen, device=dev))
    return torch.multinomial(w, n, replacement=True, generator=gen).sort().values


def clustered_features(gen: torch.Generator, assign: torch.Tensor, ids: int, dim: int,
                       latent: int):
    """L2-normalised (len(assign), dim) fp32: identity centre + FEAT_NOISE x
    noise, the centres a normal draw in a random ``latent``-dimensional
    subspace at the norm of a full-width draw."""
    dev = assign.device
    z = torch.randn((ids, latent), generator=gen, device=dev)
    basis, _ = torch.linalg.qr(torch.randn((dim, latent), generator=gen, device=dev))
    centres = z @ basis.T * (dim / latent) ** 0.5
    x = centres[assign] + FEAT_NOISE * torch.randn((assign.shape[0], dim), generator=gen,
                                                   device=dev)
    return x / x.norm(dim=1, keepdim=True)


def v_like(gen: torch.Generator, n: int, nnz: int, dev) -> torch.Tensor:
    """(n, n) non-negative rows with ~``nnz`` nonzeros summing to 1 (the
    shape of the re-ranking's V)."""
    cols = torch.randint(0, n, (n, nnz), generator=gen, device=dev)
    v = torch.zeros((n, n), device=dev).scatter_add_(
        1, cols, torch.rand((n, nnz), generator=gen, device=dev))
    return v / v.sum(1, keepdim=True)


def timed(fn):
    """(result, host seconds, peak GiB above what was allocated before) of
    one call, synchronised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - before) / 2**30)


def l5_streaming_tile(dev: torch.device) -> dict:
    """L5: the L1 kernel's general path (x is not y) on the streaming tile:
    one (512, npad) chunk of a V-like matrix against the whole (npad, npad)
    at E1's npad, against the plain version, timed beside its bound and
    ``torch.cdist(p=1)``."""
    npad = -(-(E1_Q + E1_G) // STREAM_CHUNK) * STREAM_CHUNK
    v = v_like(torch.Generator(device=dev).manual_seed(5), npad, 54, dev)
    x = v[:STREAM_CHUNK]
    out = l1.l1_distance(x, v)
    ref = l1.l1_distance_ref(x, v)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(x.abs().sum(1).max() + v.abs().sum(1).max())
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= L1_TOL,
          f"L5: L1 kernel disagrees on the streaming tile: rel {rel:.3e}")
    r = dict(shape=[STREAM_CHUNK, npad, npad], max_abs_err=err, rel=rel,
             ms=cuda_ms(lambda: l1.l1_distance(x, v), 5),
             plain_ms=cuda_ms(lambda: l1.l1_distance_ref(x, v), 1),
             library_ms=cuda_ms(lambda: torch.cdist(x, v, p=1), 2))
    r["bound_ms"], r["bound_by"] = l1_bound_ms(STREAM_CHUNK, npad, npad)
    print(f"L5 l1 streaming tile ({STREAM_CHUNK},{npad}) against ({npad},{npad}): max abs err "
          f"{err:.3e} (rel {rel:.3e}); kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
          f"torch.cdist {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
          f"general), {r['bound_ms'] / r['ms']:.1%} of bound")
    return r


def eval_protocol(dev: torch.device, latent: int = EVAL_LATENT):
    """E1's features and protocol: Q query and G gallery images of E1_IDS
    identities on E1_CAMS cameras, 6144-d."""
    gen = torch.Generator(device=dev).manual_seed(11)
    assign = identities(gen, E1_Q + E1_G, E1_IDS, 0.0, dev)
    order = torch.randperm(E1_Q + E1_G, generator=gen, device=dev)
    qi, gi = order[:E1_Q].sort().values, order[E1_Q:].sort().values
    feats = clustered_features(gen, assign, E1_IDS, 3 * 2048, latent)
    cams = torch.randint(0, E1_CAMS, (E1_Q + E1_G,), generator=gen, device=dev)
    a, c = assign.cpu().numpy(), cams.cpu().numpy()
    return feats[qi], feats[gi], a[qi.cpu()], a[gi.cpu()], c[qi.cpu()], c[gi.cpu()]


def e1_e2_eval(dev: torch.device) -> dict:
    """E1: ``streaming_rerank_eval`` at the Market-1501 test split size
    against the dense ``re_ranking`` + ``evaluate_all`` of the same
    features; E2: ``Evaluator.evaluate(rerank=True)`` on those features
    (a feature stub in place of the model), routed to streaming by the
    unchanged threshold, must return E1's numbers."""
    qf, gf, q_ids, g_ids, q_cams, g_cams = eval_protocol(dev)
    before = l1.launches
    sdiag = {}
    (s_map, s_cmc, nv), s_sec, s_peak = timed(lambda: streaming_rerank_eval(
        qf, gf, q_ids, g_ids, q_cams, g_cams, diag=sdiag))
    s_launches = l1.launches - before
    check(s_launches == -(-E1_Q // STREAM_CHUNK),
          f"E1: the L1 kernel launched {s_launches} times, expected one a query chunk")
    query = [(f"q{i}", int(p), int(c)) for i, (p, c) in enumerate(zip(q_ids, q_cams))]
    gallery = [(f"g{i}", int(p), int(c)) for i, (p, c) in enumerate(zip(g_ids, g_cams))]

    s_rows = sdiag.pop("final_rows")

    def dense():
        full = api.re_ranking(features=torch.cat([qf, gf]))
        return (api.evaluate_all(full[:E1_Q, E1_Q:], query, gallery),
                full[:s_rows.shape[0], E1_Q:].clone())

    (d, d_rows), d_sec, d_peak = timed(dense)
    rows_err = float((s_rows - d_rows).abs().max())
    del s_rows, d_rows
    gaps = {"mAP": abs(s_map - d["mAP"])}
    gaps.update({f"rank{k}": abs(float(s_cmc[k - 1]) - float(d["cmc"][k - 1])) for k in (1, 5, 10)})
    r = {"query": E1_Q, "gallery": E1_G, "dim": int(qf.shape[1]), "mAP": s_map,
         "rank1": float(s_cmc[0]), "dense_mAP": d["mAP"], "gaps": gaps, "n_valid": nv,
         "rows_max_abs_err": rows_err, "streaming_l1_launches": s_launches,
         "streaming_seconds": s_sec, "dense_seconds": d_sec, "streaming_peak_gib": s_peak,
         "dense_peak_gib": d_peak}
    print(f"E1 re-ranked evaluation, {E1_Q} x {E1_G} at {qf.shape[1]}-d: streaming mAP "
          f"{s_map:.6f} rank-1 {s_cmc[0]:.6f}, dense mAP {d['mAP']:.6f} rank-1 {d['cmc'][0]:.6f}; "
          f"gaps {gaps}; first query chunk's re-ranked rows against dense: max abs err "
          f"{rows_err:.3e}; {s_launches} L1 launches; seconds streaming {s_sec:.3f}, dense "
          f"{d_sec:.3f}; peak above the "
          f"features: streaming {s_peak:.3f} GiB, dense {d_peak:.3f} GiB")
    check(rows_err <= E1_ROWS_TOL, f"E1: re-ranked rows differ from dense by {rows_err:.3e}")
    check(gaps["mAP"] <= E1_MAP_TOL, f"E1: mAP gap {gaps['mAP']:.2e}")
    check(all(gaps[f"rank{k}"] <= 2.0 / E1_Q for k in (1, 5, 10)), f"E1: CMC gaps {gaps}")

    class FeatureStub(api.Evaluator):
        def _feats(self, dataset, items):
            return qf if items is dataset.query else gf

    class Split:
        pass

    split = Split()
    split.query, split.gallery = query, gallery
    check((E1_Q + E1_G) ** 2 * 4 > api.DENSE_RERANK_BYTES, "E2: the split does not cross")
    (e2, e2_sec, _) = timed(lambda: FeatureStub(None).evaluate(split, rerank=True))
    check(abs(e2["mAP"] - s_map) <= 1e-6 and np.allclose(e2["cmc"], s_cmc, rtol=0, atol=1e-6),
          f"E2: Evaluator.evaluate(rerank=True) returned mAP {e2['mAP']}, E1 {s_map}")
    print(f"E2 Evaluator.evaluate(rerank=True) at {E1_Q} + {E1_G}: routed to streaming, mAP "
          f"{e2['mAP']:.6f} equal to E1's; {e2_sec:.3f} s")
    r["e2_seconds"] = e2_sec
    return r


def cluster_gates(what: str, labels, counts, epss, d_labels, d_counts, d_epss) -> list[float]:
    """Per group: the same-cluster share against the dense chain's labels
    (>= SAME_CLUSTER_MIN), equal counts, eps within EPS_REL."""
    shares = []
    for g in range(len(counts)):
        share = same_cluster_share(labels[g][None], d_labels[g][None])
        shares.append(share)
        check(share >= SAME_CLUSTER_MIN and counts[g] == d_counts[g]
              and abs(epss[g] - d_epss[g]) <= EPS_REL * d_epss[g],
              f"{what} group {g}: same cluster {share:.5f}, clusters {counts[g]} against "
              f"{d_counts[g]}, eps {epss[g]} against {d_epss[g]}")
    return shares


def c1_c2_cluster(dev: torch.device) -> dict:
    """C1: ``streaming_cluster_groups`` at the DukeMTMC train split size (3
    groups of 2048-d) against the dense ``cluster_groups``; the fast path
    must engage on a group; group 0 again with ``band_cap=0`` (the forced
    fallback). C2: ``streaming_cluster`` at the MSMT17 train split size (one
    group) against the dense chain. Both report seconds and peak memory."""
    gen = torch.Generator(device=dev).manual_seed(12)
    assign = identities(gen, C1_N, C1_IDS, TRAIN_SKEW, dev)
    feats = torch.stack([clustered_features(gen, assign, C1_IDS, 2048, CLUSTER_LATENT)
                         for _ in range(C1_GROUPS)])
    diag = {}
    (s, s_sec, s_peak) = timed(lambda: streaming_cluster_groups(feats, **ANALYTICS, diag=diag))
    (d, d_sec, d_peak) = timed(lambda: api.cluster_groups(feats, **ANALYTICS))
    codes = diag["fallback_code"]
    print(f"C1 streaming_cluster_groups N={C1_N} x {C1_GROUPS} groups of 2048-d: clusters "
          f"{s[1]} (dense {d[1]}), eps {s[2]} (dense {d[2]}); fallback codes {codes}; "
          f"seconds streaming {s_sec:.3f}, dense {d_sec:.3f}; peak above the features: "
          f"streaming {s_peak:.3f} GiB, dense {d_peak:.3f} GiB")
    for g, dv in enumerate(diag["diag_vec"]):
        print(f"  group {g} diag: r_lo {dv[0]:.6f} r_hi {dv[1]:.6f} e_lo {dv[2]:.6f} e_hi "
              f"{dv[3]:.6f} region pairs {int(dv[4])} cand row max {int(dv[5])} cand total "
              f"{int(dv[6])} group max {int(dv[7])} dbscan rounds {int(dv[8])}; phase seconds "
              f"{ {k: round(v, 4) for k, v in diag['seconds'][g].items()} }")
    shares = cluster_gates("C1", *s, *d)
    check(any(c & (1 | 2 | 4 | 8) == 0 for c in codes),
          f"C1: the fast path engaged on no group (fallback codes {codes})")
    fdiag = {}
    (f, f_sec, _) = timed(lambda: streaming_cluster(feats[0], **ANALYTICS, band_cap=0, diag=fdiag))
    check(fdiag["band_fallback"], "C1: band_cap=0 did not take the fallback")
    f_share = cluster_gates("C1 band_cap=0", [f[0]], [f[1]], [f[2]], d[0][:1], d[1][:1],
                            d[2][:1])
    print(f"C1 group 0 with band_cap=0 (fallback code {fdiag['fallback_code']}): same cluster "
          f"{f_share[0]:.6f}, {f[1]} clusters, eps {f[2]}; {f_sec:.3f} s (phases "
          f"{ {k: round(v, 4) for k, v in fdiag['seconds'].items()} })")
    c1 = {"n": C1_N, "groups": C1_GROUPS, "clusters": s[1], "eps": s[2], "dense_clusters": d[1],
          "dense_eps": d[2], "same_cluster": shares, "fallback_codes": codes,
          "diag_vec": diag["diag_vec"].tolist(), "phase_seconds": diag["seconds"],
          "streaming_seconds": s_sec, "dense_seconds": d_sec,
          "streaming_peak_gib": s_peak, "dense_peak_gib": d_peak,
          "band_cap0": {"fallback_code": fdiag["fallback_code"], "same_cluster": f_share[0],
                        "clusters": f[1], "eps": f[2], "seconds": f_sec,
                        "phase_seconds": fdiag["seconds"]}}
    del feats, s, d

    gen = torch.Generator(device=dev).manual_seed(13)
    x = clustered_features(gen, identities(gen, C2_N, C2_IDS, TRAIN_SKEW, dev), C2_IDS, 2048,
                           CLUSTER_LATENT)
    c2diag = {}
    (s2, s2_sec, s2_peak) = timed(lambda: streaming_cluster(x, **ANALYTICS, diag=c2diag))
    (d2, d2_sec, d2_peak) = timed(lambda: api.cluster_groups(x[None], **ANALYTICS))
    c2_share = cluster_gates("C2", [s2[0]], [s2[1]], [s2[2]], *d2)
    print(f"C2 streaming_cluster N={C2_N} (2048-d): {s2[1]} clusters (dense {d2[1][0]}), eps "
          f"{s2[2]} (dense {d2[2][0]}), same cluster {c2_share[0]:.6f}, fallback code "
          f"{c2diag['fallback_code']}; seconds streaming {s2_sec:.3f} (phases "
          f"{ {k: round(v, 4) for k, v in c2diag['seconds'].items()} }), dense {d2_sec:.3f}; "
          f"peak above the features: streaming {s2_peak:.3f} GiB, dense {d2_peak:.3f} GiB")
    c2 = {"n": C2_N, "clusters": s2[1], "eps": s2[2], "dense_clusters": d2[1][0],
          "dense_eps": d2[2][0], "same_cluster": c2_share[0],
          "fallback_code": c2diag["fallback_code"], "phase_seconds": c2diag["seconds"],
          "streaming_seconds": s2_sec,
          "dense_seconds": d2_sec, "streaming_peak_gib": s2_peak, "dense_peak_gib": d2_peak}
    # Peak bytes per N^2 (C1's peak is one group's: the groups run in turn),
    # and the N at which C2's rate would fill the card: an extrapolation.
    total = torch.cuda.get_device_properties(0).total_memory
    for r in (c1, c2):
        for k in ("streaming", "dense"):
            r[f"{k}_bytes_per_n2"] = r[f"{k}_peak_gib"] * 2**30 / r["n"] ** 2
    ceiling = {k: int((total / c2[f"{k}_bytes_per_n2"]) ** 0.5) for k in ("streaming", "dense")}
    print(f"peak bytes per N^2: C1 streaming {c1['streaming_bytes_per_n2']:.2f}, dense "
          f"{c1['dense_bytes_per_n2']:.2f}; C2 streaming {c2['streaming_bytes_per_n2']:.2f}, "
          f"dense {c2['dense_bytes_per_n2']:.2f}; extrapolated from C2 to the card's "
          f"{total / 2**30:.1f} GiB: largest N streaming ~{ceiling['streaming']}, dense "
          f"~{ceiling['dense']}")
    return {"c1": c1, "c2": c2, "ceiling_n_extrapolated": ceiling}


# Path 6, the on-disk workflow: a raw Market-style benchmark tree written
# from the synthetic renderer (P3's target, DukeMTMC x0.2: 1120 train, 280
# query and 560 gallery images of the same identities), prepared by the
# prepare CLI, then read through DirectoryReID by the CLIs.
D_SCALE = 0.2
D_ODD = 5  # gallery files written at 128x64, Market-1501's own size, resized on decode
D_JUNK = {"bounding_box_train": 1, "bounding_box_test": 2}  # pid -1 distractor files
RAW_DIRS = (("train", "bounding_box_train"), ("query", "query"), ("gallery", "bounding_box_test"))
D2_COSINE_MIN = 0.99999  # disk against rendered embeddings of the same bytes, per row
D3_BATCH = 32  # the Inception's SSG batch: 8 whole-body clusters make a P x K batch
D3_FP32_TOL = 1e-4  # fp32 unit-norm embeddings, card against CPU: sums in another order
# KISSME: the card's and the CPU's fp32 fits are each held against the fit
# in fp64 within the first-order perturbation estimate of fp32 inverses:
# a covariance C formed and inverted with relative backward error u = 2^-24
# moves C^-1 by up to u lambda_max(C) / lambda_min(C)^2 in the 2-norm, which
# bounds every entry of M's change (the PSD projection is taken as not
# enlarging it). At 2048-d on 1120 images both covariances are singular but
# for eps, so the estimate is far above the 1e-4 of max|M| that the CPU
# tests (and the card test, card against CPU) hold at 32-64 well-conditioned
# dimensions; on clustered unit features of this shape on the CPU it sat
# ~10x above the fp32 fit's error.
FP32_U = 2.0**-24
CONV_KERNEL = r"(?i)conv|fprop|xmma|implicit|cutlass|cudnn|sm90"


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary PPM (magic ``P6``): both decoders identify it by its bytes,
    whatever the file's extension."""
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())


def write_raw_market(ds, raw_root: str, odd: int = D_ODD, junk: dict = D_JUNK,
                     chunk: int = 256) -> dict:
    """Write ``ds`` as a raw Market-1501 / DukeMTMC-reID distribution under
    ``raw_root``: ``bounding_box_train``, ``query`` and ``bounding_box_test``
    holding PPM bytes under the benchmarks' names
    ``{pid:04d}_c{cam}s1_{frame:06d}_00.jpg`` (cameras 1-based), at the
    renderer's 256x128 except the first ``odd`` gallery images (halved),
    plus ``junk[dir]`` pid -1 files. Returns, per split, the rows
    ``(raw name, pid, cam, pixels or None for a halved image)`` in the
    order ``prepare`` lists them (sorted names)."""
    out = {}
    for split, sub in RAW_DIRS:
        d = os.path.join(raw_root, sub)
        os.makedirs(d, exist_ok=True)
        items = getattr(ds, split)
        rows = []
        for s in range(0, len(items), chunk):
            part = items[s:s + chunk]
            for k, ((_, pid, cam), img) in enumerate(zip(part, ds.render([f for f, _, _ in part]))):
                name = f"{pid:04d}_c{cam + 1}s1_{s + k:06d}_00.jpg"
                small = split == "gallery" and s + k < odd
                write_ppm(os.path.join(d, name), img[::2, ::2] if small else img)
                rows.append((name, pid, cam, None if small else img))
        rng = np.random.default_rng(len(items))
        for j in range(junk.get(sub, 0)):
            write_ppm(os.path.join(d, f"-1_c1s1_{j:06d}_00.jpg"),
                      rng.integers(0, 256, (128, 64, 3), dtype=np.uint8))
        out[split] = sorted(rows, key=lambda r: r[0])
    return out


def padded_batches(images: np.ndarray, dev, bs: int = 64) -> list:
    """``images`` on the card in ``Preprocessor``'s batches: the tail padded
    with its last image, masked out."""
    out = []
    for s in range(0, len(images), bs):
        chunk = images[s:s + bs]
        n = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - n, 0)])
        mask = np.arange(bs) < n
        out.append((torch.from_numpy(chunk).to(dev), np.zeros(bs, np.int32),
                    np.zeros(bs, np.int32), mask))
    return out


def d1_prepare(root: str) -> tuple[dict, str, dict, object]:
    """D1: write the raw tree, prepare it through ``cli.prepare`` in this
    process, and check the splits (the raw tree's less the junk), the
    ``meta.json`` counts and the decode: every 256x128 image byte for byte
    the rendered one, the halved ones resized to 256x128. Prints which
    decoder ran (the native library, or PIL where it cannot be built) and
    the host decode rates of ``native_loader.load_batch`` and of
    ``Preprocessor``'s stream over the train split."""
    ds = datasets.create("dukemtmc", scale=D_SCALE, seed=0)
    raw, data_dir = os.path.join(root, "raw"), os.path.join(root, "data")
    out = os.path.join(data_dir, "dukemtmc")
    t0 = time.perf_counter()
    rows = write_raw_market(ds, raw)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(prepare_cli.main(["--dataset", "dukemtmc", "--raw_dir", raw, "--out_dir", out]) == 0,
          "D1: prepare failed")
    prepare_s = time.perf_counter() - t0
    (splits,), meta = read_json(os.path.join(out, "splits.json")), read_json(
        os.path.join(out, "meta.json"))
    sizes = {split: len(splits[split]) for split, _ in RAW_DIRS}
    check(sizes == {split: len(getattr(ds, split)) for split, _ in RAW_DIRS},
          f"D1: prepared split sizes {sizes}")
    check(meta == {"num_train_ids": ds.num_train_ids, "num_query_ids": ds.num_test_ids,
                   "images": sum(sizes.values())}, f"D1: meta.json {meta}")
    dir_ds = datasets.create("dukemtmc", root=out)
    check(isinstance(dir_ds, datasets.DirectoryReID), "D1: the prepared tree is not read from disk")
    decoder = "native" if native_loader.is_available() else "pil"
    print(f"decoder: {decoder}")
    if decoder == "pil":
        print(f"native library build: {native_loader.last_build_error()}")
    t0 = time.perf_counter()
    exact = 0
    for split, _ in RAW_DIRS:
        items = getattr(dir_ds, split)
        check([(p, c) for _, p, c in items] == [(p, c) for _, p, c, _ in rows[split]],
              f"D1: {split} identities or cameras differ from the raw tree's")
        images = dir_ds.render([f for f, _, _ in items])
        check(images.shape == (len(items), RAW_H, RAW_W, 3), f"D1: {split} shape {images.shape}")
        full = [k for k, r in enumerate(rows[split]) if r[3] is not None]
        check(np.array_equal(images[full], np.stack([rows[split][k][3] for k in full])),
              f"D1: {split}'s decoded 256x128 images differ from the rendered pixels")
        exact += len(full)
    render_s = time.perf_counter() - t0
    n = len(dir_ds.train)
    paths = [os.path.join(dir_ds.images_dir, f) for f, _, _ in dir_ds.train]
    load_batch_rate = None
    if decoder == "native":
        t0 = time.perf_counter()
        native_loader.load_batch(paths, RAW_H, RAW_W)
        load_batch_rate = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in Preprocessor(dir_ds, items=dir_ds.train, batch_size=64):
        pass
    stream_rate = n / (time.perf_counter() - t0)
    r = {"decoder": decoder, "splits": sizes, "meta": meta, "byte_exact_images": exact,
         "resized_images": D_ODD, "junk_files": sum(D_JUNK.values()), "write_seconds": write_s,
         "prepare_seconds": prepare_s, "decode_all_seconds": render_s,
         "load_batch_imgs_per_s": load_batch_rate, "stream_imgs_per_s": stream_rate,
         "host_cpus": os.cpu_count()}
    print(f"D1 prepare (DukeMTMC x{D_SCALE}, raw Market layout, PPM bytes): splits {sizes}, "
          f"meta {meta}, {exact} images decoded byte for byte, {D_ODD} resized from 128x64, "
          f"{r['junk_files']} junk files skipped; seconds: render + write {write_s:.2f}, "
          f"prepare {prepare_s:.2f}, decode all {render_s:.2f}; host decode of the {n} train "
          f"images: load_batch "
          + (f"{load_batch_rate:.0f} img/s" if load_batch_rate else "not run (no native library)")
          + f", Preprocessor stream {stream_rate:.0f} img/s ({decoder}, {os.cpu_count()} CPUs)")
    return r, data_dir, rows, dir_ds


def d2_resnet_from_disk(dev: torch.device, root: str, data_dir: str, rows: dict, dir_ds,
                        p3: dict) -> tuple[dict, torch.nn.Module]:
    """D2: ``cli.selftraining --data_dir --resume <P1> --rerank``, P3's flags
    on the prepared tree (B1 launched 4 times); then its checkpoint's
    embeddings of the train split through ``DirectoryReID`` against those
    of the rendered pixels in the same batches."""
    source = os.path.join(root, "p1", "source_checkpoint.pth")
    argv = CLI_MODEL + ["--tgt_dataset", "dukemtmc", "--data_dir", data_dir, "--iteration", "1",
                        "--resume", source, "--epochs", "2", "--rho", "1.6e-3", "--rerank"]
    r = ssg_cli("D2 selftraining --data_dir", selftraining.main, argv, os.path.join(root, "d2"),
                launches=4)
    print(f"D2 against P3 (the same 1120 images rendered): extract {r['extract_seconds']:.2f} s "
          f"from disk, {p3['extract_seconds']:.2f} s rendered; cluster {r['cluster_seconds']:.3f} "
          f"/ {p3['cluster_seconds']:.3f}; train {r['train_seconds']:.2f} / "
          f"{p3['train_seconds']:.2f}; eval {r['eval_seconds']:.2f} / {p3['eval_seconds']:.2f}")
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.load_state_dict(load_checkpoint(os.path.join(root, "d2", "checkpoint.pth"),
                                          device="cpu")["model"])
    model.to(dev, memory_format=torch.channels_last)
    disk = api.extract_features(model, Preprocessor(dir_ds, items=dir_ds.train, batch_size=64))[0]
    pixels = np.stack([img for _, _, _, img in rows["train"]])
    mem = api.extract_features(model, padded_batches(pixels, dev))[0]
    cos = float(torch.nn.functional.cosine_similarity(disk.flatten(0, 1).float(),
                                                      mem.flatten(0, 1).float(), dim=1).min())
    print(f"D2: {tuple(disk.shape)} embeddings of the train split from disk against the rendered "
          f"pixels: min per-row cosine {cos:.7f}, bit-equal {torch.equal(disk, mem)}")
    check(cos >= D2_COSINE_MIN, f"D2: disk and rendered embeddings differ: min cosine {cos:.7f}")
    r.update(min_cosine_disk_vs_rendered=cos, p3_extract_seconds=p3["extract_seconds"])
    return r, model


def d3_inception(dev: torch.device, root: str, data_dir: str, rows: dict, t2: dict) -> dict:
    """D3: the Inception at full width (depth 8, width 64, 256x128, bf16):
    ``cli.pretraining --arch inception`` (1 epoch on Market-1501 x0.1), then
    ``cli.selftraining --arch inception --data_dir --resume --rerank`` (1
    iteration, batch 32); its bf16 train step timed as T2 is, beside
    ResNet-50's; the extract of the 1120 train images, Inception and
    ResNet-50 in turns; fp32 eval embeddings on the card against the CPU;
    remat against the plain step as P5 holds it."""
    inc = ["--arch", "inception"] + CLI_MODEL[2:]
    pre = run_cli("D3 pretraining", pretraining.main,
                  inc + ["--dataset", "market1501", "--scale", CLI_SOURCE_SCALE, "--epochs", "1"],
                  os.path.join(root, "d3p"))
    (epoch,) = of_kind(pre, "pretrain_epoch")
    check(epoch["steps"] > 0 and np.isfinite(epoch["loss"]), f"D3: pretraining epoch {epoch}")
    source = os.path.join(root, "d3p", "source_checkpoint.pth")
    heads = load_checkpoint(source, device="cpu")["model"]["classifier_whole.weight"]
    check(tuple(heads.shape) == (75, 1024), f"D3: classifier {tuple(heads.shape)}, "
                                            "expected 75 identities x 1024")
    print(f"D3 pretraining --arch inception (Market-1501 x{CLI_SOURCE_SCALE}, 1 epoch): loss "
          f"{epoch['loss']:.4f}, {epoch['steps']} steps, {epoch['seconds']:.2f} s")
    argv = inc + ["--tgt_dataset", "dukemtmc", "--data_dir", data_dir, "--iteration", "1",
                  "--resume", source, "--epochs", "2", "--rho", "1.6e-3", "--rerank",
                  "--batch_size", str(D3_BATCH)]
    st = ssg_cli("D3 selftraining --arch inception --data_dir", selftraining.main, argv,
                 os.path.join(root, "d3s"), launches=4)
    ds = datasets.create("dukemtmc", scale=D_SCALE, seed=0)
    step = t2_train_step(dev, ds, arch="inception")
    print(f"D3 bf16 step at batch 64: Inception {step['train_step_ms']:.3f} ms "
          f"({step['device_events_per_step']} device events, {step['device_busy_ms_per_step']:.3f} "
          f"ms of them), ResNet-50 (T2) {t2['train_step_ms']:.3f} ms "
          f"({t2['device_events_per_step']}, {t2['device_busy_ms_per_step']:.3f} ms)")
    # The extract of the same pixels by both bf16 models, in turns.
    batches = padded_batches(np.stack([img for _, _, _, img in rows["train"]]), dev)
    nets = {}
    for arch in ("resnet50", "inception"):
        m = models.create(arch, num_features=0, num_parts=3, dtype=torch.bfloat16)
        nets[arch] = m.reset_parameters(torch.Generator().manual_seed(0)).to(
            dev, memory_format=torch.channels_last)
        api.extract_features(nets[arch], batches)  # warm-up: cuDNN plans
    secs = {a: [] for a in nets}
    for arch in ("resnet50", "inception", "inception", "resnet50"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = api.extract_features(nets[arch], batches)[0]
        torch.cuda.synchronize()
        secs[arch].append(time.perf_counter() - t0)
        check(tuple(feats.shape) == (3, 1120, 2048 if arch == "resnet50" else 1024)
              and bool(torch.isfinite(feats).all()), f"D3: {arch} extract {tuple(feats.shape)}")
    rates = {a: 1120 / min(v) for a, v in secs.items()}
    print(f"D3 extract of 1120 images (bf16, batches on the card, best of 2 in turns): Inception "
          f"{rates['inception']:.0f} img/s, ResNet-50 {rates['resnet50']:.0f} img/s")
    # fp32 eval embeddings, the card against the CPU.
    fp32 = models.create("inception", num_features=0, num_parts=3, dtype=torch.float32)
    fp32.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.stack([img for _, _, _, img in rows["query"][:8]]))
    on_cpu = copy.deepcopy(fp32).eval()
    card = api._forward_eval(fp32.to(dev, memory_format=torch.channels_last).eval(), x.to(dev))
    cpu = api._forward_eval(on_cpu, x)
    err = float((card.cpu() - cpu).abs().max())
    print(f"D3 fp32 eval embeddings {tuple(cpu.shape)}, card against CPU: max abs err {err:.3e}")
    check(tuple(cpu.shape) == (3, 8, 1024), f"D3: fp32 embeddings {tuple(cpu.shape)}")
    check(err <= D3_FP32_TOL, f"D3: fp32 embeddings differ from the CPU's by {err:.3e}")
    remat = p5_remat(dev, ds, arch="inception")
    return {"pretrain": {"loss": epoch["loss"], "steps": epoch["steps"],
                         "seconds": pre["seconds"], "l1_launches": pre["l1_launches"]},
            "selftraining": st, "train_step": step, "extract_imgs_per_s": rates,
            "extract_seconds": secs, "fp32_card_vs_cpu": err, "remat": remat}


def kissme_fp64(x: torch.Tensor, y: np.ndarray, eps: float = 1e-6, seed: int = 0,
                max_pairs: int = 50_000) -> tuple[torch.Tensor, float]:
    """KISSME's M (PSD-projected) in fp64 on the CPU, on the pairs the fit
    draws (the reference both fits are held against), and the estimate of
    an fp32 fit's largest entry error (``FP32_U`` above)."""
    from ssg_tpu_torch.metric_learning.kissme import _pairs

    x = x.double().cpu()
    sim, dis = _pairs(np.asarray(y), np.random.default_rng(seed), max_pairs)
    eye = torch.eye(x.shape[1], dtype=torch.float64)
    m, bound = 0.0, 0.0
    for pairs, sign in ((sim, 1.0), (dis, -1.0)):
        d = x[pairs[:, 0]] - x[pairs[:, 1]]
        c = d.T @ d / len(pairs) + eps * eye
        lam = torch.linalg.eigvalsh(c)
        bound += FP32_U * float(lam[-1] / lam[0] ** 2)
        m = m + sign * torch.linalg.inv(c)
    w, v = torch.linalg.eigh(m)
    return (v * w.clamp_min(0.0)) @ v.T, bound


def d4_rest(dev: torch.device, model, dir_ds, rows: dict) -> dict:
    """D4: KISSME fitted on D2's whole-body train features on the card and on
    the CPU, each held against the fit in fp64 (``M_`` and the transformed
    distances of the query features); ``DistanceMetric("kissme").train``;
    ``extract_cnn_feature`` against ``api.extract_features`` on one batch;
    ``profiling.trace`` around an extract and a ``cluster_groups``, read
    back by ``traceview.report_by_scope``, which must find the conv and L1
    kernels in their scopes; ``device_memory_stats``; ``FeatureDatabase``
    where h5py is installed."""
    feats, pids, _, _ = api.extract_features(
        model, Preprocessor(dir_ds, items=dir_ds.train, batch_size=64))
    xq = api.extract_features(model, Preprocessor(dir_ds, items=dir_ds.query, batch_size=64))[0][0]
    x = feats[0]
    t0 = time.perf_counter()
    card = KISSME().fit(x, pids)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = KISSME().fit(x.cpu(), pids, device="cpu")
    cpu_s = time.perf_counter() - t0
    m64, bound = kissme_fp64(x, pids)
    scale = float(m64.abs().max())
    err = {"M_card_vs_fp64": float((card.M_.double().cpu() - m64).abs().max()) / scale,
           "M_cpu_vs_fp64": float((cpu.M_.double() - m64).abs().max()) / scale,
           "M_card_vs_cpu": float((card.M_.cpu() - cpu.M_).abs().max()) / scale}
    q64 = xq.double().cpu()
    d64 = q64 @ m64 @ q64.T  # x^T M y; the squared distance is (x-y)^T M (x-y)
    diag = d64.diagonal()
    d64 = (diag[:, None] + diag[None, :] - 2 * d64).clamp_min(0.0)
    dscale = float(d64.abs().max())
    # |dd_ij| <= |dM|_2 |x_i - x_j|^2 for the query features.
    tol = {"M": bound / scale, "dist": bound * float(torch.cdist(q64, q64).max()) ** 2 / dscale}
    err["dist_card_vs_fp64"] = float((card.distance(xq).double().cpu() - d64).abs().max()) / dscale
    err["dist_cpu_vs_fp64"] = float((cpu.distance(xq.cpu()).double() - d64).abs().max()) / dscale
    print(f"D4 KISSME on {tuple(x.shape)} whole-body features ({len(set(pids.tolist()))} "
          f"identities): seconds card {card_s:.2f}, CPU {cpu_s:.2f}; errors of the largest "
          f"entry: " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + f"; fp32 estimates: M {tol['M']:.3e}, dist {tol['dist']:.3e}")
    for what in ("M", "dist"):
        for side in ("card", "cpu"):
            e = err[f"{what}_{side}_vs_fp64"]
            check(e <= tol[what], f"D4: KISSME {what} on the {side} is {e:.3e} of its largest "
                                  f"entry from fp64, past the fp32 estimate {tol[what]:.3e}")
    metric = DistanceMetric("kissme").train(
        model, Preprocessor(dir_ds, items=dir_ds.query, batch_size=64))
    z = metric.transform(xq)
    check(tuple(metric.metric.M_.shape) == (2048, 2048) and bool(torch.isfinite(z).all())
          and z.device.type == "cuda", "D4: DistanceMetric('kissme').train")
    batch = torch.from_numpy(dir_ds.render([f for f, _, _ in dir_ds.train[:64]])).to(dev)
    one = extract_cnn_feature(model, batch)
    ref = api.extract_features(model, [(batch, np.zeros(64), np.zeros(64), np.ones(64, bool))])[0]
    check(torch.equal(one, ref), "D4: extract_cnn_feature differs from api.extract_features")
    batches = padded_batches(np.stack([img for _, _, _, img in rows["train"]]), dev)
    with tempfile.TemporaryDirectory(prefix="ssg_trace_") as logdir:
        with profiling.trace(logdir):
            with torch.profiler.record_function("ssg_extract"):
                f = api.extract_features(model, batches)[0]
            with torch.profiler.record_function("ssg_cluster"):
                api.cluster_groups(f, **ANALYTICS)
        report = traceview.report_by_scope(logdir, r"ssg_\w+", top_ops=12)
    names = {scope: [op for (s, op) in report["by_op"] if s == scope]
             for scope in ("ssg_extract", "ssg_cluster")}
    conv = [op for op in names["ssg_extract"] if re.search(CONV_KERNEL, op)]
    l1_ops = [op for op in names["ssg_cluster"] if "l1_kernel" in op]
    print(f"D4 trace: {report['device_events']} device events, {report['total_us'] / 1e3:.3f} ms; "
          f"scopes {{{', '.join(f'{k}: {v / 1e3:.3f} ms' for k, v in report['by_scope'].items())}}}; "
          f"conv kernels in ssg_extract {len(conv)} (e.g. {conv[:1]}), L1 kernels in ssg_cluster "
          f"{l1_ops}")
    check(bool(conv), "D4: the trace shows no convolution kernel in ssg_extract")
    check(bool(l1_ops), "D4: the trace shows no L1 kernel in ssg_cluster")
    mem = profiling.device_memory_stats()
    print(f"D4 device_memory_stats: {mem}")
    check(set(mem) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
          and 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"],
          f"D4: device_memory_stats {mem}")
    if feature_database._HAVE_H5PY:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "feats.h5")
            with FeatureDatabase(path, "w") as db:
                for (fname, _, _), row in zip(dir_ds.query, xq):
                    db[fname] = row
            with FeatureDatabase(path) as db:
                back = np.stack([db[fname] for fname, _, _ in dir_ds.query])
        check(np.array_equal(back, xq.cpu().numpy()), "D4: FeatureDatabase round trip")
        database = "round trip equal"
    else:
        database = "not run: no h5py on this machine (the class is gated on it, as JAX's is)"
    print(f"D4 FeatureDatabase: {database}")
    return {"kissme_errors": err, "kissme_fp32_estimates": tol,
            "kissme_seconds": {"card": card_s, "cpu": cpu_s},
            "trace": {"device_events": report["device_events"], "ms": report["total_us"] / 1e3,
                      "by_scope_ms": {k: v / 1e3 for k, v in report["by_scope"].items()},
                      "conv_kernels": len(conv), "l1_kernels": l1_ops},
            "device_memory_stats": mem, "feature_database": database}


def data_dir_phases(dev: torch.device, root: str, cli: dict, t2: dict) -> dict:
    """Path 6: D1-D4 under ``root`` (where path 4 left P1's checkpoint)."""
    t0 = time.perf_counter()
    d1, data_dir, rows, dir_ds = d1_prepare(root)
    d2, model = d2_resnet_from_disk(dev, root, data_dir, rows, dir_ds, cli["p3"])
    d3 = d3_inception(dev, root, data_dir, rows, t2)
    d4 = d4_rest(dev, model, dir_ds, rows)
    return {"d1": d1, "d2": d2, "d3": d3, "d4": d4, "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. Build.
    t0 = time.perf_counter()
    reports = _build.build(["l1", "bottleneck", "distance"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}.cu: {line.strip()}")

    # 2. Kernel against its plain version: ragged shapes, ragged symmetric
    # ones (y is x), then a V-like sparse non-negative input at the path shape.
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(1000, 333, 777), (5, 7, 3), (65, 130, 33), (2100, 2000, 70)]
    cases += [(n, None, d) for n, d in zip(SYMMETRIC_N, (3, 7, 33, 130, 777, 1283))]
    for (m, n, d) in cases:
        x = torch.randn((m, d), generator=gen, device=dev)
        y = x if n is None else torch.randn((n, d), generator=gen, device=dev)
        err, rel = l1_errors(x, y)
        print(f"l1 ({m},{d}) against {'itself' if n is None else f'({n},{d})'}: max abs err "
              f"{err:.3e}, rel {rel:.3e}")
        check(rel <= L1_TOL, f"L1 kernel disagrees at ({m},{n},{d}): rel {rel:.3e}")
    cols = torch.randint(0, N, (N, 180), generator=gen, device=dev)
    v_like = torch.zeros((N, N), device=dev).scatter_add_(
        1, cols, torch.rand((N, 180), generator=gen, device=dev))
    v_like /= v_like.sum(1, keepdim=True)
    err, rel = l1_errors(v_like, v_like)
    print(f"l1 V-like ({N},{N})x({N},{N}): max abs err {err:.3e}, rel {rel:.3e}")
    check(rel <= L1_TOL, f"L1 kernel disagrees at the path shape: rel {rel:.3e}")
    del v_like, cols
    check_operand_conversion(dev)
    check_kernels_ragged(dev)
    check_fp32_blocks(dev)

    # 3. Main path.
    batches, model = main_path_inputs(dev)
    feats, _, _, _ = api.extract_features(model, batches)
    api.cluster_groups(feats, **ANALYTICS)  # warm-up: cuDNN/cuBLAS plans, kernel load
    torch.cuda.synchronize()

    l1.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats, _, _, _ = api.extract_features(model, batches)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels, counts, epss = api.cluster_groups(feats, **ANALYTICS)
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    main_launches = l1.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(main_launches == 3, f"L1 kernel launched {main_launches} times in the timed "
                              "cluster_groups, expected 3 (one per group)")

    print(json.dumps({
        "metric": "ssg_extract_rerank_dbscan_wallclock_market_query_3368",
        "value": extract_s + cluster_s,
        "unit": "s",
        "extract_seconds": extract_s,
        "extract_imgs_per_s": N / extract_s,
        "cluster_seconds_3groups": cluster_s,
        "clusters": counts,
        "eps": epss,
        "peak_gib": peak_gib,
        "device": name,
    }))

    # 4. Output checks.
    check(tuple(feats.shape) == (3, N, 2048), f"features shape {tuple(feats.shape)}")
    check(bool(torch.isfinite(feats).all()), "non-finite features")
    norms = feats.norm(dim=-1)
    check(float((norms - 1).abs().max()) < 1e-3, "embeddings are not unit-norm")
    check(labels.shape == (3, N) and labels.dtype == np.int32, "labels shape/type")
    for g in range(3):
        check(labels[g].min() >= -1 and labels[g].max() == counts[g] - 1,
              f"group {g}: labels do not number {counts[g]} clusters")
        check(np.isfinite(epss[g]) and epss[g] > 0, f"group {g}: eps {epss[g]}")
    check(sum(counts) > 0, "no clusters found")

    check_same_matrix(feats, "auto")

    # The same analytics with the plain L1 on the card.
    plain = api.cluster_groups(feats, **ANALYTICS, l1_impl="torch")
    check(plain[1] == counts, f"plain-L1 cluster counts {plain[1]} != {counts}")
    check(np.allclose(plain[2], epss, rtol=1e-5, atol=0), f"plain-L1 eps {plain[2]} != {epss}")
    agree = float((plain[0] == labels).mean())
    print(f"plain-L1 path: label agreement {agree:.6f}, eps {plain[2]}")
    if agree < 1.0:
        for g in range(3):
            dist = _re_ranking_impl(pairwise_distance(feats[g]), K1, K2, LAMBDA)
            near = int(((dist - epss[g]).abs() <= 1e-5 * epss[g]).sum())
            print(f"  group {g}: {near} re-ranked entries within 1e-5 of eps")
    check(agree >= 0.999, f"labels agree on only {agree:.4%} of points")

    # 5. Kernel timing at the path shape, on group 0's encoding V.
    _, v = _encode(pairwise_distance(feats[0]), K1, K2)
    err, rel = l1_errors(v, v)
    check(rel <= L1_TOL, f"L1 kernel disagrees on the main path's V: rel {rel:.3e}")
    before = l1.launches
    kernel_ms = cuda_ms(lambda: l1.l1_distance(v, v), 20)
    plain_ms = cuda_ms(lambda: l1.l1_distance_ref(v, v), 3)
    library_ms = cuda_ms(lambda: torch.cdist(v, v, p=1), 5)
    check(l1.launches - before == 21, "kernel timing did not launch the kernel")
    # The re-ranking's call is symmetric (V against itself): N(N+1)/2 pairs.
    bound_ms, bound_by = l1_bound_ms(N, N, N, symmetric=True)
    dense_ms = l1_bound_ms(N, N, N)[0]
    print(f"l1 at ({N},{N}) against itself: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.cdist {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, symmetric; "
          f"dense {dense_ms:.3f} ms), {bound_ms / kernel_ms:.1%} of bound")

    kernels = [{
        "name": "l1_distance",
        "route": "cuda",
        "source": "ssg_tpu_torch/csrc/l1.cu",
        "replaces": "ssg_tpu/ops/l1.py:27",
        "launches": main_launches,
        "max_abs_err": err,
        "max_err": rel,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "ref_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ms_dense": dense_ms,
        "library_ms": library_ms,
    }]

    # 6. The bottleneck kernel and the stage op at the path shapes.
    fused = path_model(dev, fused_eval=True)
    block_row, stage_row = check_blocks_at_path_shapes(model, fused, batches[0])

    # 7. Path 2: fused-eval extract, then the analytics.
    path2 = fused_eval_path(fused, batches, feats, labels, counts)

    paired_extract_seconds(model, fused, batches)

    # 8. The analytics from the distance kernel, and its times.
    dist_row = distance_kernel_path(feats, labels, counts, epss)

    # 9. Path 3: the fine-tuning loop (T1-T3).
    train = train_phases(dev)
    kernels[0]["launches_run_ssg"] = [it["l1_launches"] for it in train["t3"]["iterations"]]

    root = tempfile.mkdtemp(prefix="ssg_cli_")
    try:
        # 10. Path 4: the CLIs (P1-P4) and remat (P5).
        cli = cli_phases(dev, root)
        kernels[0]["launches_cli"] = {p: cli[p]["l1_launches"] for p in ("p1", "p2", "p3", "p4")}

        # 11. Path 5: large N. L5 first (its launches compare the kernel with
        # its plain version), then E1, E2, C1 and C2 with the count set to 0.
        t0 = time.perf_counter()
        tile = l5_streaming_tile(dev)
        l1.launches = 0
        large_n = {"e1": e1_e2_eval(dev), **c1_c2_cluster(dev)}
        large_n["seconds"] = time.perf_counter() - t0
        kernels[0]["launches_path5"] = l1.launches
        check(l1.launches > 0, "path 5 did not launch the L1 kernel")
        kernels[0]["streaming_tile"] = tile

        # 12. Path 6: the on-disk workflow (D1-D4), the CLIs' runs counted
        # one by one (run_cli sets the count to 0 before each).
        data_dir = data_dir_phases(dev, root, cli, train["t2"])
        kernels[0]["launches_data_dir"] = {
            "d2": data_dir["d2"]["l1_launches"],
            "d3_pretraining": data_dir["d3"]["pretrain"]["l1_launches"],
            "d3_selftraining": data_dir["d3"]["selftraining"]["l1_launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Bottleneck and stage rows: per batch of the path (the 12 identity
    # blocks; the four stages), errors in bf16 ulps (bf16_ulp_error).
    for op, row, replaces in (
            ("fused_bottleneck", block_row, "ssg_tpu/ops/bottleneck.py:70"),
            ("fused_bottleneck_stage", stage_row, "ssg_tpu/ops/bottleneck_stage.py:128")):
        kernels.append({
            "name": op, "route": "cuda", "source": "ssg_tpu_torch/csrc/bottleneck.cu",
            "replaces": replaces, "launches": path2[op], "max_abs_err": row["abs_err"],
            "max_err": row["ulps"], "max_err_unit": "bf16 ulps", "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"], "ref_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    kernels.append({
        "name": "pairwise_distance", "route": "cuda", "source": "ssg_tpu_torch/csrc/distance.cu",
        "replaces": "ssg_tpu/ops/distance.py:49", "launches": dist_row["launches"],
        "max_abs_err": dist_row["abs_err"], "max_err": dist_row["rel"],
        "max_err_unit": "of |x|^2+|y|^2", "ms": dist_row["ms"], "kernel_ms": dist_row["ms"],
        "plain_ms": dist_row["plain_ms"], "ref_ms": dist_row["plain_ms"],
        "bound_ms": dist_row["bound_ms"], "bound_by": dist_row["bound_by"],
        "bound_ms_fma_symmetric": dist_row["fma_sym_ms"],
        "max_abs_err_vs_exact": dist_row["abs_err_vs_exact"],
        "same_cluster_vs_exact": dist_row["same_cluster_vs_exact"],
        "same_cluster_vs_path1": dist_row["same_cluster_vs_path1"],
        "bound_ms_fma_dense": dist_row["fma_dense_ms"],
        "library_ms": dist_row["library_ms"],
    })
    print(json.dumps({"train": train}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"large_n": large_n}))
    print(json.dumps({"data_dir": data_dir}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
