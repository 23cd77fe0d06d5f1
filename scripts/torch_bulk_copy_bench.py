#!/usr/bin/env python3
"""How fast one block streams 8 KB chunks from L2 into a shared-memory ring,
on one CUDA card: per-thread cp.async against bulk and tensor-map copies.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 scripts/torch_bulk_copy_bench.py

The kernel (built here with ``nvcc`` into ``ssg_tpu_torch/_build/``) is the
weight stream of ``csrc/bottleneck.cu`` with the products taken out: 256
threads read 1088 chunks of 8 KB (layer4's w1, w2 and w3 of one identity
block) from a 9 MiB buffer that stays in L2, through a ring of 4-16 slots.
Each chunk arrives by

* ``cp.async``: 16 bytes a thread, a commit group a chunk, one block
  barrier a chunk (the bottleneck kernel's weight stream);
* ``bulk rows``: 32 bulk copies of 256 bytes (a K row of a 128-column
  weight tile), 4 a warp, completed on the slot's mbarrier, released by
  each warp on an empty mbarrier (the weight stream of a cluster design
  of the bottleneck kernel, with one block a cluster);
* ``bulk chunk``: one bulk copy of 8 KB;
* ``tensor-map box``: one 2-D tensor-map copy of the same 8 KB as a box of
  32 rows x 128 bf16 columns of a (rows, 512) matrix, unswizzled;
* ``bulk chunk, producer warp``: one 8 KB bulk copy, issued by a warp that
  only produces (it waits on the empty barriers and copies), while the
  other 7 warps only consume;
* ``bulk rows, producer warp``: the same, with the chunk as 32 bulk copies
  of 256 bytes at padded offsets, one a lane (what a producer warp would
  issue for the bottleneck kernel's padded weight layout);
* ``tensor-map box, producer warp``: the tensor-map box above, issued by a
  warp that only produces.
In the first four cases the copying threads also consume, in the same loop.

It prints the device time of each case and the rate at which one block
takes in its chunks, with 1 block an SM (132 blocks) and, where two fit, 2
(264), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ssg_tpu_torch.ops import _build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(sa(b)), "r"(n) : "memory");
}
__device__ __forceinline__ void expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(sa(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                 " selp.u32 %0, 1, 0, p;}" : "=r"(done) : "r"(sa(b)), "r"(parity) : "memory");
}
// Gives up after ~10 s: a copy that never lands traps instead of hanging.
__device__ __forceinline__ void wait_guarded(uint64_t* b, int parity) {
  uint32_t done = 0;
  uint64_t t0 = 0, t;
  for (int spins = 0; !done; ++spins) {
    asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                 " selp.u32 %0, 1, 0, p;}" : "=r"(done) : "r"(sa(b)), "r"(parity) : "memory");
    if ((spins & 1023) == 1023) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (!t0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void box(void* dst, const CUtensorMap* map, int x, int y, uint64_t* b) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];"
               :: "r"(sa(dst)), "l"(map), "r"(x), "r"(y), "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void bulk(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];" :: "r"(sa(dst)), "l"(src), "r"(bytes), "r"(sa(b)) : "memory");
}

constexpr int CHUNK = 8192;
constexpr int SLOT = CHUNK + 512;  // 32 rows of 256 B, each padded by 16 B

// mode 0: cp.async; mode 1: 32 bulk copies of 256 B; mode 2: one of 8 KB;
// mode 3: one tensor-map box of 32 rows x 128 bf16 columns of src viewed as
// (span / 1024, 512) bf16; mode 4: as 2, issued by warp 0, which only produces;
// mode 5: as 1, all 32 copies issued by warp 0, which only produces; mode 6:
// as 3, issued by warp 0, which only produces.
__global__ void __launch_bounds__(256) ring(const __grid_constant__ CUtensorMap map,
                                            const char* __restrict__ src, long span, int chunks,
                                            int stages, int mode, unsigned* sink) {
  extern __shared__ __align__(128) char raw[];
  char* smem = raw + ((1024 - (sa(raw) & 1023)) & 1023);  // slots 1 KB aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * SLOT);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, mode >= 4 ? 7 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long first = static_cast<long>(blockIdx.x) * 7 * CHUNK;
  auto produce = [&](int c) {
    const int slot = c % stages;
    const char* from = src + (first + static_cast<long>(c) * CHUNK) % span;
    char* to = smem + slot * SLOT;
    if (mode == 0) {
      for (int i = tid; i < CHUNK / 16; i += 256)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(sa(to + i * 16 + (i / 16) * 16)), "l"(from + i * 16));
      asm volatile("cp.async.commit_group;" ::: "memory");
      return;
    }
    if (mode == 3) {
      if (tid == 0) {
        if (c >= stages) wait_guarded(empty + slot, (c / stages - 1) & 1);
        expect_tx(full + slot, CHUNK);
        const int rows = static_cast<int>(span / 1024);
        box(to, &map, (c % 4) * 128, ((blockIdx.x * 7 + c / 4) * 32) % (rows - 32), full + slot);
      }
      return;
    }
    if (tid == 0) expect_tx(full + slot, CHUNK);
    const bool issues = mode == 1 ? lane < 4 : tid == 0;
    if (!issues) return;
    if (c >= stages) wait(empty + slot, (c / stages - 1) & 1);
    if (mode == 1) {
      const int row = warp * 4 + lane;
      bulk(to + row * 272, from + row * 256, 256, full + slot);
    } else {
      bulk(to, from, CHUNK, full + slot);
    }
  };
  unsigned acc = 0;
  if (mode >= 4) {
    if (warp == 0) {
      for (int c = 0; mode == 4 && lane == 0 && c < chunks; ++c) {
        const int slot = c % stages;
        if (c >= stages) wait(empty + slot, (c / stages - 1) & 1);
        expect_tx(full + slot, CHUNK);
        bulk(smem + slot * SLOT, src + (first + static_cast<long>(c) * CHUNK) % span, CHUNK,
             full + slot);
      }
      for (int c = 0; mode == 5 && c < chunks; ++c) {
        const int slot = c % stages;
        if (c >= stages) wait(empty + slot, (c / stages - 1) & 1);
        if (lane == 0) expect_tx(full + slot, CHUNK);
        bulk(smem + slot * SLOT + lane * 272,
             src + (first + static_cast<long>(c) * CHUNK) % span + lane * 256, 256, full + slot);
      }
      for (int c = 0; mode == 6 && lane == 0 && c < chunks; ++c) {
        const int slot = c % stages;
        if (c >= stages) wait(empty + slot, (c / stages - 1) & 1);
        expect_tx(full + slot, CHUNK);
        box(smem + slot * SLOT, &map, (c % 4) * 128,
            ((blockIdx.x * 7 + c / 4) * 32) % (static_cast<int>(span / 1024) - 32), full + slot);
      }
      return;
    }
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % stages;
      if (mode == 6) wait_guarded(full + slot, (c / stages) & 1);
      else wait(full + slot, (c / stages) & 1);
      acc += *reinterpret_cast<volatile unsigned*>(smem + slot * SLOT + (tid * 32) % CHUNK);
      __syncwarp();
      if (lane == 0) arrive(empty + slot);
    }
    if (acc == 0x9e3779b9u) sink[0] = acc;
    return;
  }
  for (int c = 0; c < stages - 1 && c < chunks; ++c) produce(c);
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % stages;
    if (mode == 0) {
      asm volatile("cp.async.wait_group 2;" ::: "memory");
      __syncthreads();
    }
    if (c + stages - 1 < chunks) produce(c + stages - 1);
    if (mode == 3) wait_guarded(full + slot, (c / stages) & 1);
    else if (mode != 0) wait(full + slot, (c / stages) & 1);
    acc += *reinterpret_cast<volatile unsigned*>(smem + slot * SLOT + (tid * 32) % CHUNK);
    if (mode != 0) {
      __syncwarp();
      if (lane == 0) arrive(empty + slot);
    }
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;  // keeps the reads
}

extern "C" int bench_ring(const void* src, long span, int chunks, int stages, int mode,
                          void* sink, int blocks, void* stream) {
  const int smem = stages * (SLOT + 16) + 1024;
  cudaError_t err = cudaFuncSetAttribute(ring, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map = {};
  if (mode == 3 || mode == 6) {
    const cuuint64_t dims[2] = {512, static_cast<cuuint64_t>(span / 1024)};
    const cuuint64_t strides[1] = {1024};
    const cuuint32_t box_dims[2] = {128, 32};
    const cuuint32_t elem[2] = {1, 1};
    // cuTensorMapEncodeTiled through the runtime's entry-point lookup: no link to libcuda.
    void* fn = nullptr;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess || fn == nullptr) return err ? err : cudaErrorInvalidValue;
    if (reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(fn)(
            &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(src), dims, strides,
            box_dims, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  ring<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const char*>(src), span, chunks, stages, mode, static_cast<unsigned*>(sink));
  return cudaGetLastError();
}
"""

CHUNKS = 1088
MODES = {0: "cp.async 16 B a thread", 1: "bulk rows, 32 x 256 B", 2: "bulk chunk, 1 x 8 KB",
         3: "tensor-map box, 32 x 128 bf16", 4: "bulk chunk, producer warp",
         5: "bulk rows, producer warp", 6: "tensor-map box, producer warp"}


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "bulk_copy_bench.cu"
    if not src.exists() or src.read_text() != SOURCE:
        src.write_text(SOURCE)
    out = _build.load(src)
    out.bench_ring.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bulk_copy_bench: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    src = torch.randint(0, 255, (9 << 20,), dtype=torch.uint8, device="cuda")
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(stages, mode, blocks):
        err = lib.bench_ring(src.data_ptr(), src.numel() - 8192, CHUNKS, stages, mode,
                             sink.data_ptr(), blocks, stream)
        if err:
            raise RuntimeError(f"bench_ring: CUDA error {err}")

    for mode in MODES:
        for stages in ((4,) if mode == 0 else (4, 8, 16)):
            for blocks in ((132, 264) if stages <= 8 else (132,)):  # 2 an SM fit up to 8
                launch(stages, mode, blocks)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    launch(stages, mode, blocks)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / 5
                print(f"{MODES[mode]}, {stages} slots, {blocks} blocks: {ms:.3f} ms, "
                      f"{CHUNKS * 8192 / ms / 1e6:.2f} GB/s a block")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
