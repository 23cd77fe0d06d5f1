// Eval-mode ResNet bottleneck with BatchNorm folded into the convolutions,
// bf16 activations, fp32 accumulation, NHWC:
//
//   y1  = bf16(relu(x @ w1 + b1))                  1x1, C -> Cm
//   y2  = bf16(relu(conv3x3_s(y1) + b2))           3x3, stride s, pad 1
//   out = bf16(relu(y2 @ w3 + b3 + res))           1x1, Cm -> Cout
//   res = x                           (identity block: s = 1, Cout = C)
//       = x[:, ::s, ::s] @ wd + bd    (downsample block, s in {1, 2})
//
// Replaces two TPU kernels: ssg_tpu/ops/bottleneck.py:_kernel (the identity
// block, launched by fused_bottleneck) is the <1, false> instance, and
// ssg_tpu/ops/bottleneck_stage.py:_stage_kernel (a whole stage, launched by
// fused_bottleneck_stage) becomes one <s, true> launch for the first block
// followed by <1, false> launches for the identity blocks. A stage does not
// fit one Hopper block: one image's layer1 activation is 64*32*256*2 B =
// 1 MiB against 227 KB of shared memory, so the block outputs pass through
// device memory (a layer3 activation at batch 128 is 33.5 MB, inside the
// 50 MB L2).
//
// What it keeps from the TPU kernel: y1 and y2 never reach device memory.
// A block reads its x tile (plus a one-pixel halo) and writes its out tile
// once. That holds for bf16; an fp32 block (ssg_bottleneck_f32, at the end)
// is a run of 3xTF32 tensor-core launches with y1 and y2 in device memory.
//
// Bound on an H100 at the ResNet-50 path shapes (batch 128): every block
// does 17 Cm^2 multiply-adds a pixel, 36.5 GFLOP, 36.9 us on the bf16 tensor
// cores (989 TFLOP/s dense). Reading x and writing out takes 80 / 40 / 20 /
// 10 us in layer1..layer4 (268 / 134 / 67 / 34 MB at 3.35 TB/s), so layer1
// is bound by bytes and layers 3-4 by operations.
//
// Design. A block owns TR x TC output pixels of one image (at most 128). It
//   1. computes y1 on the (TR-1)s+3 x (TC-1)s+3 input pixels under the 3x3
//      window into shared memory, zero outside the image (the conv padding);
//   2. computes y2 for its pixels into shared memory: an implicit GEMM whose
//      A rows are gathered from y1 with one ldmatrix row address per lane;
//   3. computes out = relu(y2 @ w3 (+ xs @ wd) + bias (+ x)) and stores it.
// Each product is mma.sync m16n8k16 (bf16 in, fp32 accumulators), 8 consumer
// warps over a GEMM tile of 128 rows x 64 columns (64 x 128 when the tile
// has few rows). A ninth warp only produces: one of its lanes issues every
// operand copy of the block, in the consumers' order, as a tensor-map (TMA)
// box, and runs ahead across passes and phases (nothing it loads depends on
// y1 or y2). A chunk is 64 deep in K:
//   - weights: w1 (C, Cm), w2 as (9 Cm, Cm), w3 (Cm, Cout), wd (C, Cout),
//     row-major, one or two boxes of 64 K rows x 64 N columns (128 B a row)
//     into a slot of the B ring (2-8 slots);
//   - x for the first 1x1 product: the halo window in bands of whole rows,
//     one box of 64 channels x TCin x BR pixels of the (B, H, W, C) tensor
//     map (rows and columns outside the image read as zeros), into a slot of
//     the A ring (2-3 slots); for the downsample product, 64 channels x TC x
//     TR pixels with element strides (1, s, s, 1).
// A chunk lands on its B slot's "full" mbarrier (the producer's
// arrive.expect_tx counts every box's whole bytes, zero fill included);
// each consumer warp releases the slots on their "empty" mbarriers, so no
// block barrier sits inside a K loop (the consumers meet on a named barrier
// between phases). Every box lands 128B-swizzled (16-byte piece j of a
// 128-byte row r at j ^ (r mod 8), slots 1024-byte aligned): the consumers'
// ldmatrix rows fall on distinct banks with no padding. Rows past K and
// columns past N are the box's zero fill, which is exact. y1 and y2 keep
// padded rows, written by the consumers' epilogues, and the 3x3 taps go
// through a small table; y1 is zeroed outside the image by the epilogue (a
// zero-filled pixel gives relu(b1), not 0). A wait on an mbarrier traps
// after ~10 s, so a wrong byte count fails the launch instead of hanging.
//
// The two instances share the set-up and phases 1-2 (y1_y2) and differ in
// the tile walk and phase 3. Both run two blocks an SM where shared memory
// allows (nine warps twice over: 96 registers a thread, a little spilled),
// else one. The identity kernel (12 blocks a batch) runs one tile a block
// and releases a chunk's slots after the chunk's products (its y2 shares
// the A ring, and at 96 registers more live state spilled more and cost
// 6-16 %). The downsample kernel walks over its tiles (the producer fetches
// the next tile during this tile's epilogue) and releases a chunk's slots
// before its last products; only layer1's fits two blocks an SM.
// Against the design before it (a cp.async ring of 32-deep chunks staged
// by all 256 threads, a block barrier each) on an H100 at the path shapes,
// in turns (scripts/torch_bottleneck_ab.py), the identity block takes
// 0.86 / 0.80 / 0.79 / 0.57 of its time in layers 1-4 and the downsample
// block 0.82 / 0.53 / 0.56 / 0.48, so both instances keep this design.
// What bounds them is inferred from those calls (PERF.md), not profiled:
// layer1's 2048 short tiles, latency (a second resident block hides it: the
// downsample block at one block an SM took the ring's time); layers 2-3,
// the consumers' fragment loads and mma.sync products at these warp tiles;
// layer4, the weight stream (8.9 MB a block, the same boxes for all 128
// blocks), not its ring's depth (4 and 7 slots took the same time).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;      // consumer threads of a bf16 block; an fp32 kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_THREADS = THREADS + 32;  // + the producer warp
constexpr int KC = 64;            // K per ring chunk: one box row per K row
constexpr int BOX_N = 64;         // weight columns of a box: 128 B a row
constexpr int BOX_BYTES = KC * BOX_N * 2;
constexpr int ROW_BYTES = 128;    // a box row: 64 bf16 (K rows of weights, pixels of x)
constexpr int MAX_B_STAGES = 8;   // weight ring slots
constexpr int MAX_A_STAGES = 3;   // x ring slots
constexpr int MAX_STRIPS = 2;     // 16-row strips a warp holds per pass
constexpr int PAD = 8;            // bf16 of y1 / y2 row padding: ldmatrix rows on distinct banks
constexpr int MT_MAX = 128;       // rows of one pass
constexpr int P_MAX = 128;        // output pixels a block owns
constexpr int TCIN_MAX = 128;     // halo columns: a band of whole halo rows fits one pass
constexpr int SMEM_LIMIT = 232448;      // one block's dynamic shared memory
constexpr int SMEM_TWO_PER_SM = 115712;  // (228 KB - 2 x 1 KB reserved) / 2
constexpr int ALIGN = 1024;       // 128B-swizzled boxes repeat every 1024 bytes

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// GEMM columns a pass covers: the warp grid by the pass's rows, and whether
// the launch lets short passes take the wide grid (16 KB weight slots).
__host__ __device__ constexpr int pass_nc(int rows, bool wide) {
  return rows <= 64 && wide ? 128 : 64;
}

// Shared-memory layout of a launch, from a 1024-byte aligned base: the B
// ring (sb slots of b_slot bytes: weight boxes), the A ring (sa slots of
// a_slot: x boxes; an identity block's y2 takes its place after phase 1),
// y2 (downsample), y1, then 8 zeros, the mbarriers (full and empty a B
// slot, empty an A slot: a chunk's x box lands on its B slot's full
// barrier) and the 3x3 tap table.
struct Layout {
  int TRin, TCin, BR;  // halo window; halo rows of a phase-1 band
  int rows1;           // GEMM rows of a full band
  bool wide;
  int sb, sa, b_slot, a_slot, off_a, off_y2, off_y1, off_misc, bytes;
};

Layout layout(int TR, int TC, int S, bool ds, int Cm, int sb, int sa, bool wide) {
  Layout t;
  t.TRin = (TR - 1) * S + 3;
  t.TCin = (TC - 1) * S + 3;
  const int bands = cdiv(t.TRin, MT_MAX / t.TCin < t.TRin ? MT_MAX / t.TCin : t.TRin);
  t.BR = cdiv(t.TRin, bands);
  t.rows1 = round16(t.BR * t.TCin);
  t.wide = wide;
  t.sb = sb;
  t.sa = sa;
  const int Pp = round16(TR * TC);
  const int nc1 = pass_nc(t.rows1, wide), nc2 = pass_nc(Pp, wide);
  t.b_slot = (nc1 > nc2 ? nc1 : nc2) * KC * 2;
  t.a_slot = (ds && Pp > t.rows1 ? Pp : t.rows1) * ROW_BYTES;
  const int y1 = round16(t.TRin * t.TCin) * (Cm + PAD) * 2;
  const int y2 = Pp * (Cm + PAD) * 2;
  t.off_a = sb * t.b_slot;
  if (ds) {
    t.off_y2 = t.off_a + sa * t.a_slot;
    t.off_y1 = t.off_y2 + y2;
  } else {
    t.off_y2 = t.off_a;
    t.off_y1 = t.off_a + (sa * t.a_slot > y2 ? sa * t.a_slot : y2);
  }
  t.off_misc = t.off_y1 + y1;
  t.bytes = t.off_misc + 16 + 8 * (2 * sb + sa) + 9 * Cm / 8 * 4 + ALIGN;  // + the base's alignment
  return t;
}

struct Params {
  CUtensorMap map_x;   // x (B, H, W, C): phase-1 boxes of 64 x TCin x BR x 1
  CUtensorMap map_xs;  // x, strided: 64 x TC x TR pixels (downsample only)
  CUtensorMap map_w1, map_w2, map_w3, map_wd;  // 64 x 64 boxes of (K, N)
  const bf16* x;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;
  bf16* out;
  int B, H, W, C, Cm, Cout, Ho, Wo;
  int TR, TC, tiles_r, tiles_c;
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(b)) : "memory");
}
// Waits for the phase of parity `parity` to complete; traps after ~10 s, so
// a copy that never lands (a wrong byte count) fails the launch.
__device__ __forceinline__ void wait_guarded(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0, t;
  for (int spins = 0; !done; ++spins) {
    asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                 " selp.u32 %0, 1, 0, p;}\n"
                 : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    if (!done && (spins & 1023) == 1023) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (!t0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void box2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                      uint64_t* b) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void box4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                      int c3, uint64_t* b) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The consumers' barrier between phases (named barrier 1: the producer warp
// is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// Warp grid over one pass: WC column groups of 32 output columns, 8 / WC row
// groups; warp (wr, wc) holds strips wr and wr + WR. WC = 2 covers 128 rows
// x 64 columns, WC = 4 covers 64 rows x 128 columns.
template <int WC>
struct Grid {
  static constexpr int WR = WARPS / WC;
  static constexpr int NC = 32 * WC;
};

using Acc = float[MAX_STRIPS][4][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int s = 0; s < MAX_STRIPS; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][t][i] = 0.f;
}

// Positions in the two rings: the slot of the next chunk, the parity of its
// fill and the chunks so far. The producer and every consumer warp walk the
// same chunk sequence.
struct Pos {
  int slot = 0;
  uint32_t parity = 0;
  int count = 0;
  __device__ __forceinline__ void next(int stages) {
    ++count;
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
};
struct Ring {
  uint64_t* full;     // a B slot's fill, its x box included
  uint64_t* empty;    // a B slot released by every consumer warp
  uint64_t* empty_a;  // an A slot released
  int sb, sa;
  Pos b, a;
};

// acc[rows of this pass, n0 .. n0 + NC) += A[rows, 0..K) @ B[0..K, n0 ..),
// B's 64-deep chunks taken from the ring (slot s at Bs + s * b_slot, as one
// or two swizzled 64 x 64 boxes; with A_BOX, A's from the A ring too). With
// EARLY, a whole chunk's slots are released as soon as its last step has
// read them, before that step's products (with A_BOX the step then holds
// both strips' A fragments: more live registers); else after the chunk.
// row_base(m) is the per-row part of A's shared address, taken once per
// strip before the K loop; a_addr(a_slot, base, k) is the shared address of
// A[m, k .. k + 8) for k < K, a multiple of 8; zero8 holds 8 zeros (A's K
// padding).
template <int WC, bool A_BOX, bool EARLY, class RowBase, class AAddr>
__device__ __forceinline__ void mma_pass(Acc& acc, int strips, int K, Ring& ring, uint32_t Bs,
                                         int b_slot, uint32_t zero8, RowBase row_base,
                                         AAddr a_addr) {
  using G = Grid<WC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / WC;
  const int wc = warp % WC;

  int base[MAX_STRIPS];
#pragma unroll
  for (int s = 0; s < MAX_STRIPS; ++s) {
    const int strip = wr + G::WR * s;
    base[s] = strip < strips ? row_base(strip * 16 + (lane & 15)) : 0;
  }
  // This lane's ldmatrix.trans row of B in a chunk: K row ks * 16 + (lane &
  // 15), 16-byte piece of column wc * 32 + np * 16 + (lane >> 4) * 8 of its
  // box, swizzled by the row (lane & 7).
  uint32_t b_off[2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    const int col = wc * 32 + np * 16 + (lane >> 4) * 8;
    b_off[np] = (col / BOX_N) * BOX_BYTES + (lane & 15) * ROW_BYTES +
                ((((col % BOX_N) >> 3) ^ (lane & 7)) << 4);
  }

  // One 16-deep step of the chunk in B slot bs: B fragments for the warp's
  // 32 columns, each strip's A fragment and its four products, calling
  // `loaded()` once the step has read the ring (with EARLY and A_BOX, after
  // both strips' A fragments: the step then holds them, more live
  // registers). `tail`: the chunk ends inside K, so A columns past K read
  // zeros.
  auto step = [&](uint32_t bs, int k0, int ks, bool tail, auto loaded) {
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4_t(r, bs + b_off[np] + ks * 16 * ROW_BYTES);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
    const int k = k0 + ks * 16 + (lane >> 4) * 8;
    auto a_src = [&](int s) { return !tail || k < K ? a_addr(ring.a.slot, base[s], k) : zero8; };
    if constexpr (EARLY && A_BOX) {
      uint32_t a[MAX_STRIPS][4];
#pragma unroll
      for (int s = 0; s < MAX_STRIPS; ++s)
        if (wr + G::WR * s < strips) ldsm_x4(a[s], a_src(s));
      loaded();
#pragma unroll
      for (int s = 0; s < MAX_STRIPS; ++s)
        if (wr + G::WR * s < strips)
#pragma unroll
          for (int t = 0; t < 4; ++t) mma16816(acc[s][t], a[s], b[t][0], b[t][1]);
    } else {
      loaded();
#pragma unroll
      for (int s = 0; s < MAX_STRIPS; ++s) {
        if (wr + G::WR * s < strips) {
          uint32_t a[4];
          ldsm_x4(a, a_src(s));
#pragma unroll
          for (int t = 0; t < 4; ++t) mma16816(acc[s][t], a, b[t][0], b[t][1]);
        }
      }
    }
  };
  // The warp's last read of the chunk's slots is done: release them.
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) {
      arrive(ring.empty + ring.b.slot);
      if (A_BOX) arrive(ring.empty_a + ring.a.slot);
    }
  };

  for (int k0 = 0; k0 < K; k0 += KC) {
    wait_guarded(ring.full + ring.b.slot, ring.b.parity);
    const uint32_t bs = Bs + ring.b.slot * b_slot;
    if (k0 + KC <= K) {
      // A whole chunk: straight-line code, so the compiler can issue the
      // later steps' fragment loads under the earlier steps' products.
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        step(bs, k0, ks, false, [&] {
          if (EARLY && ks == KC / 16 - 1) release();
        });
      if (!EARLY) release();
    } else {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        if (k0 + ks * 16 >= K) break;
        step(bs, k0, ks, true, [] {});
      }
      release();
    }
    ring.b.next(ring.sb);
    if constexpr (A_BOX) ring.a.next(ring.sa);
  }
}

// This thread's bias pairs of a pass: bias[n], bias[n + 1] for its four
// columns n = n0 + wc * 32 + t * 8 + 2 * (lane & 3), t < 4 (0 past N). Read
// before the pass's K loop, so the loads' latency hides behind the products.
template <int WC>
__device__ __forceinline__ void load_bias(float2 (&out)[4], const float* bias, int N, int n0) {
  const int lane = threadIdx.x & 31;
  const int wc = (threadIdx.x >> 5) % WC;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int n = n0 + wc * 32 + t * 8 + 2 * (lane & 3);
    out[t] = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
  }
}

// Calls f(s, t, h, m, n) for each accumulator pair this thread holds:
// acc[s][t][2h], acc[s][t][2h + 1] are output (m, n) and (m, n + 1).
template <int WC, class F>
__device__ __forceinline__ void for_each_pair(int strips, int n0, F f) {
  using G = Grid<WC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / WC;
  const int wc = warp % WC;
#pragma unroll
  for (int s = 0; s < MAX_STRIPS; ++s) {
    const int strip = wr + G::WR * s;
    if (strip >= strips) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(s, t, h, strip * 16 + (lane >> 2) + 8 * h, n0 + wc * 32 + t * 8 + 2 * (lane & 3));
  }
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One pass of a GEMM over `rows` rows, choosing the warp grid by row count
// as pass_nc does.
#define SSG_PASS(ROWS, WIDE, ...)      \
  if ((ROWS) <= 64 && (WIDE)) {        \
    constexpr int WC = 4;              \
    __VA_ARGS__                        \
  } else {                             \
    constexpr int WC = 2;              \
    __VA_ARGS__                        \
  }

// The producer: every chunk of the block in the consumers' order. A chunk is
// the weight boxes of K rows k0 .. k0 + 63 and columns n0 .. n0 + nc (those
// that start inside N) into a B slot, plus, for a product with x, one box of
// x at (k0, w, h, b) of `a_bytes` bytes (the whole box, its zero fill
// included) into an A slot, all landing on the B slot's full barrier.
template <int S, bool DS>
__device__ void produce(const Params& p, Ring& ring, unsigned char* Bs, unsigned char* As,
                        int b, int r0, int c0) {
  const Layout& L = p.L;
  auto chunks = [&](const CUtensorMap* wmap, int K, int N, int n0, int nc,
                    const CUtensorMap* amap, int aw, int ah, int a_bytes) {
    for (int k0 = 0; k0 < K; k0 += KC) {
      if (ring.b.count >= ring.sb) wait_guarded(ring.empty + ring.b.slot, ring.b.parity ^ 1);
      if (amap != nullptr && ring.a.count >= ring.sa)
        wait_guarded(ring.empty_a + ring.a.slot, ring.a.parity ^ 1);
      uint64_t* full = ring.full + ring.b.slot;
      const int boxes = cdiv(N - n0, BOX_N) < nc / BOX_N ? cdiv(N - n0, BOX_N) : nc / BOX_N;
      expect_tx(full, boxes * BOX_BYTES + (amap != nullptr ? a_bytes : 0));
      for (int j = 0; j < boxes; ++j)
        box2d(Bs + ring.b.slot * L.b_slot + j * BOX_BYTES, wmap, n0 + j * BOX_N, k0, full);
      ring.b.next(ring.sb);
      if (amap != nullptr) {
        box4d(As + ring.a.slot * L.a_slot, amap, k0, aw, ah, b, full);
        ring.a.next(ring.sa);
      }
    }
  };
  // 1. y1, band by band of the halo window.
  const int nc1 = pass_nc(L.rows1, L.wide);
  for (int band = 0; band * L.BR < L.TRin; ++band)
    for (int n0 = 0; n0 < p.Cm; n0 += nc1)
      chunks(&p.map_w1, p.C, p.Cm, n0, nc1, &p.map_x, c0 * S - 1, r0 * S - 1 + band * L.BR,
             L.BR * L.TCin * ROW_BYTES);
  // 2. y2.
  const int nc2 = pass_nc(round16(p.TR * p.TC), L.wide);
  for (int n0 = 0; n0 < p.Cm; n0 += nc2)
    chunks(&p.map_w2, 9 * p.Cm, p.Cm, n0, nc2, nullptr, 0, 0, 0);
  // 3. out: w3, then (downsample) wd with the strided x.
  for (int n0 = 0; n0 < p.Cout; n0 += nc2) {
    chunks(&p.map_w3, p.Cm, p.Cout, n0, nc2, nullptr, 0, 0, 0);
    if (DS)
      chunks(&p.map_wd, p.C, p.Cout, n0, nc2, &p.map_xs, c0 * S, r0 * S,
             p.TR * p.TC * ROW_BYTES);
  }
}

// A block's shared memory as its Layout carves it, with the mbarriers and
// the 3x3 tap table set up.
struct Block {
  unsigned char* Bs;  // the B ring
  unsigned char* As;  // the A ring
  bf16* y1s;
  bf16* y2s;
  uint32_t bs, as, z8;  // shared addresses of the two rings and of 8 zeros
  const int* ktab;      // ktab[k / 8] = y1 offset of A column k = (dr*3 + dc)*Cm + j
  Ring ring;
  // A from an x box in the A ring: pixel row m at base m * ROW_BYTES,
  // 128B-swizzled.
  __device__ __forceinline__ uint32_t box(int a_slot, int slot, int base, int k) const {
    return as + slot * a_slot + base + ((((k >> 3) & 7) ^ (threadIdx.x & 7)) << 4);
  }
};

// Run by every thread of the block; ends on the last block-wide barrier (the
// producer warp leaves after it).
__device__ __forceinline__ Block setup(const Params& p, unsigned char* smem_raw) {
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const Layout& L = p.L;
  Block k;
  k.Bs = smem;
  k.As = smem + L.off_a;
  k.y2s = reinterpret_cast<bf16*>(smem + L.off_y2);
  k.y1s = reinterpret_cast<bf16*>(smem + L.off_y1);
  bf16* zero8 = reinterpret_cast<bf16*>(smem + L.off_misc);
  k.ring.full = reinterpret_cast<uint64_t*>(smem + L.off_misc + 16);
  k.ring.empty = k.ring.full + L.sb;
  k.ring.empty_a = k.ring.empty + L.sb;
  k.ring.sb = L.sb;
  k.ring.sa = L.sa;
  int* ktab = reinterpret_cast<int*>(k.ring.empty_a + L.sa);
  if (threadIdx.x < 8) zero8[threadIdx.x] = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 9 * p.Cm / 8; i += BLOCK_THREADS) {
    const int tap = i * 8 / p.Cm;
    ktab[i] = ((tap / 3) * L.TCin + tap % 3) * (p.Cm + PAD) + i * 8 - tap * p.Cm;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.sb; ++s) {
      bar_init(k.ring.full + s, 1);
      bar_init(k.ring.empty + s, WARPS);
    }
    for (int s = 0; s < L.sa; ++s) bar_init(k.ring.empty_a + s, WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  k.ktab = ktab;
  k.bs = smem_u32(k.Bs);
  k.as = smem_u32(k.As);
  k.z8 = smem_u32(zero8);
  return k;
}

// Phases 1 and 2 of the consumers on the tile of image b at output row r0,
// column c0: y1 on the halo window, then y2, into shared memory, each phase
// ending on the consumers' barrier. EARLY as in mma_pass.
template <int S, bool EARLY>
__device__ __forceinline__ void y1_y2(const Params& p, Block& k, Acc& acc, int r0, int c0) {
  const Layout& L = p.L;
  const int TCin = L.TCin;
  const int M1 = L.TRin * TCin;
  const int P = p.TR * p.TC;
  const int LD1 = p.Cm + PAD;
  const int hi0 = r0 * S - 1;  // input row of halo row 0
  const int wi0 = c0 * S - 1;

  // 1. y1 on the halo window, band by band (BR halo rows each), zero outside
  // the image. A band's last strip may run past its rows, over slot bytes
  // from an earlier box: those rows are the next band's and are not stored.
  auto box_base = [](int m) { return m * ROW_BYTES; };
  auto box_addr = [&](int slot, int base, int kk) { return k.box(L.a_slot, slot, base, kk); };
  SSG_PASS(L.rows1, L.wide, {
    for (int mb = 0; mb < M1; mb += L.BR * TCin) {
      const int rows = min(L.BR * TCin, M1 - mb);
      const int strips = round16(rows) / 16;
      for (int n0 = 0; n0 < p.Cm; n0 += Grid<WC>::NC) {
        float2 bias[4];
        load_bias<WC>(bias, p.b1, p.Cm, n0);
        zero_acc(acc);
        mma_pass<WC, true, EARLY>(acc, strips, p.C, k.ring, k.bs, L.b_slot, k.z8, box_base,
                                  box_addr);
        for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
          if (n >= p.Cm || m >= rows) return;
          const int hi = hi0 + (mb + m) / TCin;
          const int wi = wi0 + (mb + m) % TCin;
          const bool in = hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
          store2(k.y1s + (mb + m) * LD1 + n, in ? fmaxf(acc[s][t][2 * h] + bias[t].x, 0.f) : 0.f,
                 in ? fmaxf(acc[s][t][2 * h + 1] + bias[t].y, 0.f) : 0.f);
        });
      }
    }
  })
  consumers_sync();

  // 2. y2 = relu(conv3x3_s(y1) + b2): A[m, (dr*3 + dc)*Cm + j] =
  // y1[(r*S + dr)*TCin + c*S + dc, j] for output pixel m = (r, c).
  const int strips = round16(P) / 16;
  const uint32_t y1a = smem_u32(k.y1s);
  auto row_base = [&](int m) {
    if (m >= P) m = 0;  // padding rows: any finite row
    return (m / p.TC * S * TCin + m % p.TC * S) * LD1;
  };
  auto a_addr = [&](int, int base, int kk) -> uint32_t {
    return y1a + (base + k.ktab[kk >> 3]) * 2;
  };
  SSG_PASS(round16(P), L.wide, {
    for (int n0 = 0; n0 < p.Cm; n0 += Grid<WC>::NC) {
      float2 bias[4];
      load_bias<WC>(bias, p.b2, p.Cm, n0);
      zero_acc(acc);
      mma_pass<WC, false, EARLY>(acc, strips, 9 * p.Cm, k.ring, k.bs, L.b_slot, k.z8, row_base,
                                 a_addr);
      for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
        if (n >= p.Cm) return;
        store2(k.y2s + m * LD1 + n, fmaxf(acc[s][t][2 * h] + bias[t].x, 0.f),
               fmaxf(acc[s][t][2 * h + 1] + bias[t].y, 0.f));
      });
    }
  })
  consumers_sync();
}

// NHWC offset in out of row m of the tile of image b at output row r0,
// column c0, or -1 (a padding row, or past the image).
__device__ __forceinline__ int64_t out_pixel(const Params& p, int b, int r0, int c0, int m) {
  if (m >= p.TR * p.TC) return -1;
  const int r = r0 + m / p.TC;
  const int c = c0 + m % p.TC;
  if (r >= p.Ho || c >= p.Wo) return -1;
  return (static_cast<int64_t>(b) * p.Ho + r) * p.Wo + c;
}

// The identity block (stride 1, Cout == C), a block a tile: its y2 takes
// the A ring's place after phase 1, so no later tile's boxes may follow.
// Two blocks share an SM where they fit (96 registers a thread).
__global__ void __launch_bounds__(BLOCK_THREADS, 2)
    identity_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(ALIGN) unsigned char smem_raw[];
  Block k = setup(p, smem_raw);
  int bid = blockIdx.x;
  const int c0 = bid % p.tiles_c * p.TC;
  bid /= p.tiles_c;
  const int r0 = bid % p.tiles_r * p.TR;
  const int b = bid / p.tiles_r;
  if (threadIdx.x >= THREADS) {
    if (threadIdx.x == THREADS) produce<1, false>(p, k.ring, k.Bs, k.As, b, r0, c0);
    return;
  }
  Acc acc;
  y1_y2<1, false>(p, k, acc, r0, c0);

  // 3. out = relu(y2 @ w3 + b3 + x).
  const bf16* __restrict__ x = p.x;
  const int strips = round16(p.TR * p.TC) / 16;
  const uint32_t y2a = smem_u32(k.y2s);
  auto y2_base = [&](int m) { return m * (p.Cm + PAD); };
  auto y2_addr = [&](int, int base, int kk) -> uint32_t { return y2a + (base + kk) * 2; };
  SSG_PASS(strips * 16, p.L.wide, {
    for (int n0 = 0; n0 < p.Cout; n0 += Grid<WC>::NC) {
      // The pass's residual (x at the output pixels) is loaded before its
      // K loop, so the loads' latency hides behind the products.
      __nv_bfloat162 res[MAX_STRIPS][4][2];
      for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
        const int64_t pix = out_pixel(p, b, r0, c0, m);
        res[s][t][h] = pix < 0 || n >= p.Cout
                           ? __floats2bfloat162_rn(0.f, 0.f)
                           : *reinterpret_cast<const __nv_bfloat162*>(x + pix * p.C + n);
      });
      float2 bias[4];
      load_bias<WC>(bias, p.b3, p.Cout, n0);
      zero_acc(acc);
      mma_pass<WC, false, false>(acc, strips, p.Cm, k.ring, k.bs, p.L.b_slot, k.z8, y2_base,
                                 y2_addr);
      for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
        const int64_t pix = out_pixel(p, b, r0, c0, m);
        if (pix < 0 || n >= p.Cout) return;
        store2(p.out + pix * p.Cout + n,
               fmaxf(acc[s][t][2 * h] + bias[t].x + __bfloat162float(res[s][t][h].x), 0.f),
               fmaxf(acc[s][t][2 * h + 1] + bias[t].y + __bfloat162float(res[s][t][h].y), 0.f));
      });
    }
  })
}

// The downsample block (stride S, a strided 1x1 product as its residual):
// BLOCKS blocks an SM (one: ~140 registers a thread, two: 96), which walk
// over the tiles t = blockIdx.x, + gridDim.x, ..., so the producer loads the
// next tile while the consumers finish this one; a chunk's slots are
// released before its last products.
template <int S, int BLOCKS>
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCKS)
    downsample_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(ALIGN) unsigned char smem_raw[];
  Block k = setup(p, smem_raw);
  const int tiles = p.B * p.tiles_r * p.tiles_c;
  auto tile = [&](int t, int& b, int& r0, int& c0) {
    c0 = t % p.tiles_c * p.TC;
    t /= p.tiles_c;
    r0 = t % p.tiles_r * p.TR;
    b = t / p.tiles_r;
  };
  if (threadIdx.x >= THREADS) {
    if (threadIdx.x == THREADS) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, r0, c0;
        tile(t, b, r0, c0);
        produce<S, true>(p, k.ring, k.Bs, k.As, b, r0, c0);
      }
    }
    return;
  }

  const int strips = round16(p.TR * p.TC) / 16;
  const uint32_t y2a = smem_u32(k.y2s);
  auto y2_base = [&](int m) { return m * (p.Cm + PAD); };
  auto y2_addr = [&](int, int base, int kk) -> uint32_t { return y2a + (base + kk) * 2; };
  // The strided residual x[r*S, c*S]: the box's pixel m is tile row m.
  auto box_base = [](int m) { return m * ROW_BYTES; };
  auto box_addr = [&](int slot, int base, int kk) { return k.box(p.L.a_slot, slot, base, kk); };
  Acc acc;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int b, r0, c0;
    tile(t, b, r0, c0);
    y1_y2<S, true>(p, k, acc, r0, c0);

    // 3. out = relu(y2 @ w3 + b3 + xs @ wd + bd).
    SSG_PASS(strips * 16, p.L.wide, {
      for (int n0 = 0; n0 < p.Cout; n0 += Grid<WC>::NC) {
        float2 bias[4], bias_d[4];
        load_bias<WC>(bias, p.b3, p.Cout, n0);
        load_bias<WC>(bias_d, p.bd, p.Cout, n0);
        zero_acc(acc);
        mma_pass<WC, false, true>(acc, strips, p.Cm, k.ring, k.bs, p.L.b_slot, k.z8, y2_base,
                                  y2_addr);
        mma_pass<WC, true, true>(acc, strips, p.C, k.ring, k.bs, p.L.b_slot, k.z8, box_base,
                                 box_addr);
        for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
          const int64_t pix = out_pixel(p, b, r0, c0, m);
          if (pix < 0 || n >= p.Cout) return;
          store2(p.out + pix * p.Cout + n,
                 fmaxf(acc[s][t][2 * h] + bias[t].x + bias_d[t].x, 0.f),
                 fmaxf(acc[s][t][2 * h + 1] + bias[t].y + bias_d[t].y, 0.f));
        });
      }
    })
  }
}

#undef SSG_PASS

// Output tile, rings and layout of a launch. The tile: at most cap pixels
// (full output width where it fits, up to TCIN_MAX halo columns, then as
// many rows as fit), shrunk until its shared memory fits with a 4-slot
// weight ring, then evened out so the ragged last tile wastes as little as
// the tile count allows; cap starts at 128 and halves, down to 32, while the
// grid has fewer blocks than the 132 SMs of an H100. The rings: the deepest
// weight ring (then x ring) that lets two blocks share an SM, with the wide
// grid for short passes, else with the narrow one (8 KB weight slots), else
// the deepest for one block an SM. Measured on an H100: a second resident
// block beats a deeper ring (its products and epilogues fill the first
// one's waits), for both instances.
bool plan(int B, int Ho, int Wo, int S, bool ds, int Cm, int* TR, int* TC, Layout* L) {
  for (int cap = P_MAX;; cap /= 2) {
    int tc = Wo < cap ? Wo : cap;
    if (tc > (TCIN_MAX - 3) / S + 1) tc = (TCIN_MAX - 3) / S + 1;
    int tr = Ho < cap / tc ? Ho : cap / tc;
    while (layout(tr, tc, S, ds, Cm, 4, 2, true).bytes > SMEM_LIMIT) {
      if (tr > 1) --tr;
      else if (tc > 1) --tc;
      else return false;
    }
    const int tiles_r = cdiv(Ho, tr);
    const int tiles_c = cdiv(Wo, tc);
    *TR = cdiv(Ho, tiles_r);
    *TC = cdiv(Wo, tiles_c);
    if (static_cast<int64_t>(B) * tiles_r * tiles_c >= 132 || cap <= 32) break;
  }
  const struct { int limit; bool wide; } tries[3] = {
      {SMEM_TWO_PER_SM, true}, {SMEM_TWO_PER_SM, false}, {SMEM_LIMIT, true}};
  for (const auto& t : tries) {
    for (int sb = MAX_B_STAGES; sb >= 2; --sb)
      for (int sa = MAX_A_STAGES; sa >= 2; --sa) {
        *L = layout(*TR, *TC, S, ds, Cm, sb, sa, t.wide);
        if (L->bytes <= t.limit) return true;
      }
  }
  return false;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup: no link
// to libcuda. nullptr if the driver has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault) != cudaSuccess) {
      cudaGetLastError();
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 tensor map with 128B-swizzled boxes and zero fill: dims and box
// innermost first, strides in bytes of dims 1 .. rank - 1.
bool encode(CUtensorMap* map, int rank, const void* ptr, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* elem) {
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (K, N) bf16 weight in 64 x 64 boxes.
bool encode_weight(CUtensorMap* map, const void* w, int K, int N) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {BOX_N, KC};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, 2, w, dims, strides, box, elem);
}

// x (B, H, W, C) in boxes of 64 channels x bw x bh pixels, every s-th
// column and row.
bool encode_x(CUtensorMap* map, const void* x, int B, int H, int W, int C, int bw, int bh, int s) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {KC, static_cast<cuuint32_t>(bw * s),
                             static_cast<cuuint32_t>(bh * s), 1};
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(s), static_cast<cuuint32_t>(s), 1};
  return encode(map, 4, x, dims, strides, box, elem);
}

// fp32 blocks. The TPU kernel takes fp32 activations too (its products take
// x.dtype), and an fp32 block here is a run of conv_f32_kernel launches (y1,
// y2 and a downsample block's residual pass through device memory), each
//
//   out[m, n] = act(sum_k A[m, k] w[k, n] + bias[n] (+ res[m, n]))
//
// with output pixel m = (b, ho, wo), k = (dr R + dc) Cin + ci and A[m, k] =
// in[b, ho S + dr - R / 2, wo S + dc - R / 2, ci], zero outside the image.
//
// Bound on an H100: operations. At the path shapes (batch 128) an identity
// block does 36.5 GFLOP: 0.545 ms on the fp32 FMA pipes (67 TFLOP/s), 0.221
// ms as three TF32 tensor-core products (495 TFLOP/s), against 0.160 ms to
// read x and write out in fp32 at layer1.
//
// Design: distance.cu's 3xTF32 machinery as an implicit GEMM. A block owns
// 128 output pixels x BN output channels (BN = 128; 64 where Cout <= 64,
// layer1's conv1 and conv2, so half the tile is not masked away, and where
// K is 4 slabs or fewer, so two blocks an SM overlap one tile's epilogue
// with the other's slabs: 1.07-1.15x on layers 1-2 in turns) and walks
// K in 32-deep slabs through a 4-slot cp.async ring, one block barrier a
// slab. A slab's A rows are gathered by 16-byte pieces, 4 channels of one
// tap of one pixel (Cin % 4 == 0, so a piece never crosses a tap); pad
// pixels and the K tail load zeros by src-size 0. Each tile row's (image,
// h, w) origin is computed once, into a shared table. A is stored K-major,
// rows padded to 36 floats, so ldmatrix gives the tf32 A fragments as
// they are; w (K, Cout) keeps N contiguous, rows padded to BN + 8 floats
// (= 8 mod 32 words), so a B fragment's 32-bit loads fall on 32 distinct
// banks (those rows by cp.async too: in turns they beat one thread's
// tensor-map box a slab by 1.5-2.7 % on layers 2-4). Eight warps each
// hold 64 x BN / 4 outputs; every fragment is split by cvt.rna.tf32 into
// hi and lo, and three mma.sync m16n8k8 a fragment pair (lo.hi, hi.lo,
// hi.hi) go into a per-slab partial sum that an fp32 add folds into the
// accumulator (the tensor cores' accumulation does not round to nearest;
// see distance.cu). The epilogue stages the tile in the ring and stores
// it as coalesced 16-byte rows, adding the bias, then the residual, then
// the ReLU. BN = 128 takes one block an SM (4 x 35 KB of ring, ~220
// registers), BN = 64 two (127). No K split: layer4's convolutions have
// 128-512 tiles for 132 SMs.
constexpr int F_BM = 128;               // output pixels of a block
constexpr int F_BK = 32;                // K per ring slab
constexpr int F_STAGES = 4;             // cp.async ring slots
constexpr int F_LDA = F_BK + 4;         // A slab row stride (144 B): ldmatrix on distinct banks
constexpr int F_WM = 64;                // rows a warp: 2 warps down the tile, 4 across
constexpr int F_MT = F_WM / 16;         // m16 fragments a warp
constexpr int F_A_FLOATS = F_BM * F_LDA;

template <int BN>
struct TileF32 {
  static constexpr int LDB = BN + 8;    // B slab row stride in floats: = 8 (mod 32) words
  static constexpr int WN = BN / 4;     // columns a warp
  static constexpr int NT = WN / 8;     // n8 fragments a warp
  static constexpr int SLOT = F_A_FLOATS + F_BK * LDB;
  static constexpr int LDT = BN + 8;    // staged output row stride: float2 stores on distinct banks
  static constexpr int SMEM_BYTES = F_STAGES * SLOT * 4;  // 143,360 (BN 128) / 110,592 (BN 64)
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static_assert(F_BM * LDT <= F_STAGES * SLOT, "the output tile is staged in the ring");
};

struct ConvF32 {
  const float* in;    // (B, H, W, Cin) NHWC
  const float* w;     // (R * R * Cin, Cout) row-major (HWIO flattened)
  const float* bias;  // (Cout,)
  const float* res;   // (B, Ho, Wo, Cout) added before the ReLU, or nullptr
  float* out;         // (B, Ho, Wo, Cout)
  int B, H, W, Cin, Ho, Wo, Cout, S;
  bool relu;
};

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo, both tf32; lo is rounded from the exact fp32 remainder.
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(__uint_as_float(v));
  lo = tf32(__uint_as_float(v) - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slab kt of the block's A rows and w rows into ring slot `slot`. Thread tid
// copies A rows tid / 8 + 32 i at k tid % 8 * 4 (8 threads read a row's 128
// bytes), and w rows of BN / 4 pieces, a row's neighbouring threads on
// neighbouring addresses.
template <int BN, int R>
__device__ __forceinline__ void load_slab_f32(const ConvF32& p, const int4* rows, float* slot,
                                              int kt, int K, int n0, int tid) {
  using T = TileF32<BN>;
  const int a_r = tid >> 3;
  const int k = kt * F_BK + (tid & 7) * 4;
  int tap = 0, ci = k;
  if constexpr (R > 1) {
    tap = k / p.Cin;
    ci = k - tap * p.Cin;
  }
  const int dr = tap / R, dc = tap % R;
  const bool k_valid = k < K;
#pragma unroll
  for (int i = 0; i < F_BM / 32; ++i) {
    const int r = a_r + 32 * i;
    const int4 o = rows[r];  // (pixel of (b, 0, 0), h0, w0)
    const int h = o.y + dr, w = o.z + dc;
    const bool valid = k_valid && h >= 0 && h < p.H && w >= 0 && w < p.W;
    const float* src = p.in + (static_cast<int64_t>(o.x) + static_cast<int64_t>(h) * p.W + w) *
                                  p.Cin + ci;
    cp_async16(slot + r * F_LDA + (tid & 7) * 4, valid ? src : p.in, valid);
  }
  constexpr int PER_ROW = BN / 4;
  constexpr int STEP = THREADS / PER_ROW;  // w rows a pass
  const int b_r = tid / PER_ROW, b_n = tid % PER_ROW * 4;
  const bool n_valid = n0 + b_n < p.Cout;
  float* Bs = slot + F_A_FLOATS;
#pragma unroll
  for (int i = 0; i < F_BK / STEP; ++i) {
    const int kr = kt * F_BK + b_r + STEP * i;
    const bool valid = n_valid && kr < K;
    cp_async16(Bs + (b_r + STEP * i) * T::LDB + b_n,
               valid ? p.w + static_cast<int64_t>(kr) * p.Cout + n0 + b_n : p.w, valid);
  }
}

template <int BN, int R>
__global__ void __launch_bounds__(THREADS, TileF32<BN>::MIN_BLOCKS)
conv_f32_kernel(const ConvF32 p) {
  using T = TileF32<BN>;
  extern __shared__ __align__(16) float fsm[];
  __shared__ int4 rows[F_BM];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int tiles_n = (p.Cout + BN - 1) / BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / tiles_n) * F_BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * BN;
  const int64_t M = static_cast<int64_t>(p.B) * p.Ho * p.Wo;
  const int K = R * R * p.Cin;
  const int kt_end = (K + F_BK - 1) / F_BK;

  if (tid < F_BM) {
    const int64_t m = m0 + tid;
    int4 o = make_int4(0, -(1 << 30), 0, 0);  // past the last pixel: every tap reads zeros
    if (m < M) {
      const int wo = static_cast<int>(m % p.Wo);
      const int64_t t = m / p.Wo;
      o.x = static_cast<int>(t / p.Ho) * p.H * p.W;
      o.y = static_cast<int>(t % p.Ho) * p.S - R / 2;
      o.z = wo * p.S - R / 2;
    }
    rows[tid] = o;
  }
  __syncthreads();

  float acc[F_MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < F_MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < kt_end) load_slab_f32<BN, R>(p, rows, fsm + s * T::SLOT, s, K, n0, tid);
    cp_async_commit();
  }

  // ldmatrix row of this lane in an A slab (as distance.cu's): matrices
  // rows 0-7 / 8-15 at k 0-3, then at k 4-7 = a0..a3 of m16n8k8. A B
  // fragment is w[k = tig (+4)][n = gid] of the lane's n8 column group.
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t a_lane =
      smem_u32(fsm + (wm * F_WM + (lane & 7) + ((lane >> 3) & 1) * 8) * F_LDA + (lane >> 4) * 4);
  const float* b_lane = fsm + F_A_FLOATS + tig * T::LDB + wn * T::WN + gid;

  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    // Refill the slot that slab kt - 1 used: every thread is past it.
    const int nk = kt + F_STAGES - 1;
    if (nk < kt_end) load_slab_f32<BN, R>(p, rows, fsm + (nk % F_STAGES) * T::SLOT, nk, K, n0, tid);
    cp_async_commit();

    const int slot = (kt % F_STAGES) * T::SLOT;
    float part[F_MT][T::NT][4];
#pragma unroll
    for (int i = 0; i < F_MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 8) {
      uint32_t bhi[T::NT][2], blo[T::NT][2];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float* b = b_lane + slot + kk * T::LDB + j * 8;
        split(__float_as_uint(b[0]), bhi[j][0], blo[j][0]);
        split(__float_as_uint(b[4 * T::LDB]), bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < F_MT; ++i) {
        uint32_t a[4], ahi[4], alo[4];
        ldsm_x4(a, a_lane + (slot + i * 16 * F_LDA + kk) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(a[q], ahi[q], alo[q]);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          mma_tf32(part[i][j], alo, bhi[j][0], bhi[j][1]);
          mma_tf32(part[i][j], ahi, blo[j][0], blo[j][1]);
          mma_tf32(part[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < F_MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }

  // Stage the tile in the ring: fragment element c of (i, j) is row gid
  // (+8 for c >= 2), column 2 tig + (c & 1).
  cp_async_wait<0>();
  __syncthreads();
  float* tile = fsm;
#pragma unroll
  for (int i = 0; i < F_MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int r = wm * F_WM + i * 16 + gid;
      const int c = wn * T::WN + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(tile + r * T::LDT + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * T::LDT + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  constexpr int C4 = BN / 4;
  for (int idx = tid; idx < F_BM * C4; idx += THREADS) {
    const int r = idx / C4;
    const int c = idx % C4 * 4;
    const int64_t m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= p.Cout) continue;
    float4 v = *reinterpret_cast<const float4*>(tile + r * T::LDT + c);
    const float4 b = *reinterpret_cast<const float4*>(p.bias + n);
    v.x += b.x;
    v.y += b.y;
    v.z += b.z;
    v.w += b.w;
    if (p.res != nullptr) {
      const float4 q = *reinterpret_cast<const float4*>(p.res + m * p.Cout + n);
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    if (p.relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    *reinterpret_cast<float4*>(p.out + m * p.Cout + n) = v;
  }
}

template <int BN, int R>
cudaError_t launch_conv_f32(const ConvF32& p, int64_t tiles_m, cudaStream_t stream) {
  const int64_t blocks = tiles_m * ((p.Cout + BN - 1) / BN);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = TileF32<BN>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(conv_f32_kernel<BN, R>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  conv_f32_kernel<BN, R><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// R is 1 or 3; Cin and Cout multiples of 4; every pointer 16-byte aligned.
cudaError_t conv_f32(const float* in, const float* w, const float* bias, const float* res,
                     float* out, int B, int H, int W, int Cin, int Cout, int R, int S, bool relu,
                     cudaStream_t stream) {
  const ConvF32 p{in, w, bias, res, out, B, H, W, Cin, (H - 1) / S + 1, (W - 1) / S + 1, Cout,
                  S, relu};
  const int64_t tiles_m = (static_cast<int64_t>(B) * p.Ho * p.Wo + F_BM - 1) / F_BM;
  if (Cout <= 64 || R * R * Cin <= 4 * F_BK)
    return R == 1 ? launch_conv_f32<64, 1>(p, tiles_m, stream)
                  : launch_conv_f32<64, 3>(p, tiles_m, stream);
  return R == 1 ? launch_conv_f32<128, 1>(p, tiles_m, stream)
                : launch_conv_f32<128, 3>(p, tiles_m, stream);
}

// Blocks an SM of a launch with this layout.
int blocks_per_sm(const Layout& L) { return L.bytes <= SMEM_TWO_PER_SM ? 2 : 1; }

// Blocks of a launch of `tiles` tiles: one a tile, or, for a downsample
// block, at most as many as the SMs hold (the kernel's blocks walk over the
// tiles).
cudaError_t grid_size(int64_t tiles, bool ds, const Layout& L, int* grid) {
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  *grid = static_cast<int>(tiles);
  if (!ds) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks_per_sm(L) * sms < *grid) *grid = blocks_per_sm(L) * sms;
  return err;
}

}  // namespace

// Output tile, grid size and dynamic shared memory of a launch (ds != 0: a
// downsample block), for tests and reports: out[0..4] = TR, TC, blocks,
// shared bytes, ring slots. Returns 0, or cudaErrorInvalidValue if no tile
// fits.
extern "C" int ssg_bottleneck_plan(int64_t B, int64_t H, int64_t W, int64_t Cm, int64_t stride,
                                   int64_t ds, int64_t* out) {
  const int Ho = static_cast<int>((H - 1) / stride + 1);
  const int Wo = static_cast<int>((W - 1) / stride + 1);
  int TR, TC;
  Layout L;
  if (!plan(static_cast<int>(B), Ho, Wo, static_cast<int>(stride), ds != 0, static_cast<int>(Cm),
            &TR, &TC, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid;
  const cudaError_t err =
      grid_size(B * ((Ho + TR - 1) / TR) * ((Wo + TC - 1) / TC), ds != 0, L, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = TR;
  out[1] = TC;
  out[2] = grid;
  out[3] = L.bytes;
  out[4] = L.sb;
  return 0;
}

// x (B, H, W, C), out (B, Ho, Wo, Cout) with Ho = ceil(H / stride): bf16,
// NHWC-contiguous. w1 (C, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, Cout), wd (C, Cout):
// bf16 row-major; b1, b2 (Cm,), b3, bd (Cout,): fp32. wd == nullptr selects
// the identity block (stride 1, Cout == C). C, Cm, Cout multiples of 8;
// x and the weights 16-byte aligned (tensor maps), the rest 4-byte aligned.
// Encodes the launch's tensor maps (cudaErrorInvalidValue if one fails),
// launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int ssg_bottleneck(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, const void* w3, const float* b3, const void* wd,
                              const float* bd, void* out, int64_t B, int64_t H, int64_t W,
                              int64_t C, int64_t Cm, int64_t Cout, int64_t stride, void* stream) {
  const bool ds = wd != nullptr;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; };
  if ((stride != 1 && stride != 2) || (!ds && (stride != 1 || Cout != C)) || C % 8 || Cm % 8 ||
      Cout % 8 || B <= 0 || H <= 0 || W <= 0 || misaligned(x) || misaligned(w1) ||
      misaligned(w2) || misaligned(w3) || (ds && misaligned(wd)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.b1 = b1;
  p.b2 = b2;
  p.b3 = b3;
  p.bd = bd;
  p.out = static_cast<bf16*>(out);
  p.B = static_cast<int>(B);
  p.H = static_cast<int>(H);
  p.W = static_cast<int>(W);
  p.C = static_cast<int>(C);
  p.Cm = static_cast<int>(Cm);
  p.Cout = static_cast<int>(Cout);
  p.Ho = static_cast<int>((H - 1) / stride + 1);
  p.Wo = static_cast<int>((W - 1) / stride + 1);
  const int s = static_cast<int>(stride);
  if (!plan(p.B, p.Ho, p.Wo, s, ds, p.Cm, &p.TR, &p.TC, &p.L))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_r = (p.Ho + p.TR - 1) / p.TR;
  p.tiles_c = (p.Wo + p.TC - 1) / p.TC;
  const int64_t blocks = B * p.tiles_r * p.tiles_c;
  if (!encode_x(&p.map_x, x, p.B, p.H, p.W, p.C, p.L.TCin, p.L.BR, 1) ||
      !encode_weight(&p.map_w1, w1, p.C, p.Cm) || !encode_weight(&p.map_w2, w2, 9 * p.Cm, p.Cm) ||
      !encode_weight(&p.map_w3, w3, p.Cm, p.Cout) ||
      (ds && (!encode_x(&p.map_xs, x, p.B, p.H, p.W, p.C, p.TC, p.TR, s) ||
              !encode_weight(&p.map_wd, wd, p.C, p.Cout))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = blocks_per_sm(p.L) == 2;
  void (*kernel)(const Params) =
      !ds ? identity_kernel
          : stride == 1 ? (two ? downsample_kernel<1, 2> : downsample_kernel<1, 1>)
                        : (two ? downsample_kernel<2, 2> : downsample_kernel<2, 1>);
  int grid;
  cudaError_t err = grid_size(blocks, ds, p.L, &grid);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), BLOCK_THREADS, p.L.bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The same block in fp32: every tensor fp32, NHWC-contiguous, plus device
// workspaces y1 (B, H, W, Cm), y2 (B, Ho, Wo, Cm) and, for a downsample
// block, res (B, Ho, Wo, Cout). C, Cm, Cout multiples of 4 and every
// pointer 16-byte aligned (the kernel's 16-byte copies and stores), else
// cudaErrorInvalidValue. Launches conv_f32_kernel three times (four for a
// downsample block) on `stream`; returns the first CUDA error, or 0.
extern "C" int ssg_bottleneck_f32(const float* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* w3,
                                  const float* b3, const float* wd, const float* bd, float* out,
                                  float* y1, float* y2, float* res, int64_t B, int64_t H,
                                  int64_t W, int64_t C, int64_t Cm, int64_t Cout, int64_t stride,
                                  void* stream) {
  const bool ds = wd != nullptr;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; };
  if ((stride != 1 && stride != 2) || (!ds && (stride != 1 || Cout != C)) || B <= 0 || H <= 0 ||
      W <= 0 || C <= 0 || Cm <= 0 || Cout <= 0 || C % 4 || Cm % 4 || Cout % 4 ||
      B * H * W > 2147483647LL || misaligned(x) || misaligned(w1) || misaligned(b1) ||
      misaligned(w2) || misaligned(b2) || misaligned(w3) || misaligned(b3) || misaligned(out) ||
      misaligned(y1) || misaligned(y2) ||
      (ds && (misaligned(wd) || misaligned(bd) || misaligned(res))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H), w = static_cast<int>(W);
  const int c = static_cast<int>(C), cm = static_cast<int>(Cm), cout = static_cast<int>(Cout);
  const int s = static_cast<int>(stride);
  const int ho = (h - 1) / s + 1, wo = (w - 1) / s + 1;
  cudaError_t err = conv_f32(x, w1, b1, nullptr, y1, b, h, w, c, cm, 1, 1, true, st);
  if (err == cudaSuccess) err = conv_f32(y1, w2, b2, nullptr, y2, b, h, w, cm, cm, 3, s, true, st);
  if (err == cudaSuccess && ds) err = conv_f32(x, wd, bd, nullptr, res, b, h, w, c, cout, 1, s,
                                               false, st);
  if (err == cudaSuccess) err = conv_f32(y2, w3, b3, ds ? res : x, out, b, ho, wo, cm, cout, 1, 1,
                                         true, st);
  return static_cast<int>(err);
}
