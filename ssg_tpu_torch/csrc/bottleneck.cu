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
// is a run of plain fp32 FMA launches with y1 and y2 in device memory.
//
// Bound on an H100 at the ResNet-50 path shapes (batch 128): every block
// does 17 Cm^2 multiply-adds a pixel, 36.5 GFLOP, 36.9 us on the bf16 tensor
// cores (989 TFLOP/s dense). Reading x and writing out takes 80 / 40 / 20 /
// 10 us in layer1..layer4 (268 / 134 / 67 / 34 MB at 3.35 TB/s), so layer1
// is bound by bytes and layers 3-4 by operations.
//
// Design (right and simple first; wgmma and TMA are later work). A block of
// 256 threads owns TR x TC output pixels of one image (at most 128). It
//   1. computes y1 on the (TR-1)s+3 x (TC-1)s+3 input pixels under the 3x3
//      window into shared memory, zero outside the image (the conv padding);
//   2. computes y2 for its pixels into shared memory: an implicit GEMM whose
//      A rows are gathered from y1 with one ldmatrix row address per lane;
//   3. computes out = relu(y2 @ w3 (+ xs @ wd) + bias (+ x)) and stores it.
// Each product is mma.sync m16n8k16 (bf16 in, fp32 accumulators), 8 warps
// over a GEMM tile of 128 rows x 64 columns (64 x 128 when the tile has few
// rows). Weights are streamed from L2 in 32-deep K chunks through a cp.async
// ring of 2-4 slots (up to three chunks in flight while one is used), since
// layer4's w2 alone is 4.7 MB; x chunks for the 1x1 products go through the
// same ring. Shared addresses are computed per row once a pass, and the 3x3
// taps through a small table, so the K loop holds loads and mma only.
// Ragged H, W, C, Cm and Cout (multiples of 8) are masked here: K padding
// loads zeros, which is exact.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int KC = 32;            // K per staged chunk
constexpr int MAX_STAGES = 4;     // cp.async ring slots: up to three chunks in flight
constexpr int MAX_STRIPS = 2;     // 16-row strips a warp holds per pass
constexpr int PAD = 8;            // bf16 of row padding: ldmatrix rows on distinct banks
constexpr int LDA = KC + PAD;     // staged A chunk row stride
constexpr int NC_MAX = 128;
constexpr int LDB_MAX = NC_MAX + PAD;
constexpr int MT_MAX = 128;       // rows of one pass
constexpr int P_MAX = 128;        // output pixels a block owns
constexpr int A_PIECES = KC / 8;  // 16-byte pieces in a staged A row
constexpr int A_ROWS = MT_MAX * A_PIECES / THREADS;  // staged A rows a thread copies
constexpr int SMEM_LIMIT = 232448;      // one block's dynamic shared memory
constexpr int SMEM_TWO_PER_SM = 115712;  // (228 KB - 2 x 1 KB reserved) / 2

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

struct Params {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* w3;
  const float* b3;
  const bf16* wd;
  const float* bd;
  bf16* out;
  int B, H, W, C, Cm, Cout, Ho, Wo;
  int TR, TC, tiles_r, tiles_c;
  int stages;  // cp.async ring slots, 2..MAX_STAGES
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most stages - 2 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) asm volatile("cp.async.wait_group 2;\n" ::);
  else if (stages == 3) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp grid over one pass: WC column groups of 32 output columns, 8 / WC row
// groups; warp (wr, wc) holds strips wr and wr + WR. WC = 2 covers 128 rows
// x 64 columns, WC = 4 covers 64 rows x 128 columns.
template <int WC>
struct Grid {
  static constexpr int WR = 8 / WC;
  static constexpr int NC = 32 * WC;
  static constexpr int LDB = NC + PAD;
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

// acc[rows of this pass, n0 .. n0 + NC) += A[rows, 0..K) @ Bg[0..K, n0 ..).
// Bg is (K, N) row-major bf16 in device memory, staged KC rows at a time
// through the ring Bs of `stages` slots. issue_a(buf, kc) stages chunk kc of A
// into ring slot buf (if A is staged). row_base(m) is the per-row part of
// A's shared address, taken once per strip before the K loop; a_ptr(buf,
// base, k) is the shared address of A[m, k .. k + 8) for k < K, a multiple
// of 8. zero8 holds 8 zeros (A's K padding).
template <int WC, class IssueA, class RowBase, class APtr>
__device__ __forceinline__ void mma_pass(Acc& acc, int strips, int K, const bf16* __restrict__ Bg,
                                         int N, int n0, bf16* Bs, const bf16* zero8, int stages,
                                         IssueA issue_a, RowBase row_base, APtr a_ptr) {
  using G = Grid<WC>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp / WC;
  const int wc = warp % WC;
  const int nk = (K + KC - 1) / KC;

  int base[MAX_STRIPS];
#pragma unroll
  for (int s = 0; s < MAX_STRIPS; ++s) {
    const int strip = wr + G::WR * s;
    base[s] = strip < strips ? row_base(strip * 16 + (lane & 15)) : 0;
  }

  auto issue = [&](int buf, int kc) {
    constexpr int PIECES = G::NC / 8;  // 16-byte pieces in a staged B row
#pragma unroll
    for (int i = tid; i < KC * PIECES; i += THREADS) {
      const int k = i / PIECES;
      const int piece = i % PIECES;
      const int gk = kc * KC + k;
      const int gn = n0 + piece * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + (buf * KC + k) * G::LDB + piece * 8,
                 ok ? Bg + static_cast<int64_t>(gk) * N + gn : Bg, ok);
    }
    issue_a(buf, kc);
  };

  for (int st = 0; st < stages - 1; ++st) {
    if (st < nk) issue(st, st);
    cp_async_commit();
  }
  int buf = 0;                // slot of chunk kc
  int next_buf = stages - 1;  // slot of chunk kc + stages - 1
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait_ring(stages);  // chunk kc has landed
    __syncthreads();             // ... for every thread, and slot kc - 1 is free
    if (kc + stages - 1 < nk) issue(next_buf, kc + stages - 1);
    cp_async_commit();
    const bf16* bs = Bs + buf * KC * G::LDB;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if (kc * KC + ks * 16 >= K) break;
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + (ks * 16 + (lane & 15)) * G::LDB + wc * 32 + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
      const int k = kc * KC + ks * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int s = 0; s < MAX_STRIPS; ++s) {
        if (wr + G::WR * s < strips) {
          uint32_t a[4];
          ldsm_x4(a, k < K ? a_ptr(buf, base[s], k) : zero8);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma16816(acc[s][t], a, b[t][0], b[t][1]);
        }
      }
    }
    buf = buf + 1 == stages ? 0 : buf + 1;
    next_buf = next_buf + 1 == stages ? 0 : next_buf + 1;
  }
  __syncthreads();  // the next pass's prologue refills the ring
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

// Hands each accumulator pair to epi(m, n, v(m, n), v(m, n + 1)).
template <int WC, class Epi>
__device__ __forceinline__ void epilogue(const Acc& acc, int strips, int n0, Epi epi) {
  for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
    epi(m, n, acc[s][t][2 * h], acc[s][t][2 * h + 1]);
  });
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// A staged from x: this thread copies piece (tid % A_PIECES) of rows
// tid / A_PIECES + (THREADS / A_PIECES) j, j < A_ROWS, of each chunk; pix[j]
// is that row's NHWC pixel, or -1 for a zero row. The copies land in ring
// slot buf of As.
struct StagedX {
  bf16* As;
  const bf16* x;
  int C;
  int64_t pix[A_ROWS];

  template <class Pixel>
  __device__ __forceinline__ StagedX(bf16* As_, const bf16* x_, int C_, int rows, Pixel pixel)
      : As(As_), x(x_), C(C_) {
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      const int m = threadIdx.x / A_PIECES + (THREADS / A_PIECES) * j;
      pix[j] = m < rows ? pixel(m) : -1;
    }
  }
  __device__ __forceinline__ void operator()(int buf, int kc) const {
    const int piece = threadIdx.x % A_PIECES;
    const int k = kc * KC + piece * 8;
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      const int m = threadIdx.x / A_PIECES + (THREADS / A_PIECES) * j;
      const bool ok = pix[j] >= 0 && k < C;
      cp_async16(As + (buf * MT_MAX + m) * LDA + piece * 8, ok ? x + pix[j] * C + k : x, ok);
    }
  }
};

// One pass of a GEMM over `rows` rows, choosing the warp grid by row count.
#define SSG_PASS(ROWS, ...)            \
  if ((ROWS) <= 64) {                  \
    constexpr int WC = 4;              \
    __VA_ARGS__                        \
  } else {                             \
    constexpr int WC = 2;              \
    __VA_ARGS__                        \
  }

template <int S, bool DS>
__global__ void __launch_bounds__(THREADS) bottleneck_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TRin = (p.TR - 1) * S + 3;
  const int TCin = (p.TC - 1) * S + 3;
  const int M1 = TRin * TCin;
  const int M1p = round16(M1);
  const int P = p.TR * p.TC;
  const int Pp = round16(P);
  const int LD1 = p.Cm + PAD;

  // An identity block stages no A after phase 1, so y2 takes the A ring's
  // place; a downsample block stages strided x beside y2 in phase 3.
  const int stages = p.stages;
  bf16* y1s = reinterpret_cast<bf16*>(smem);
  bf16* As = y1s + M1p * LD1;
  bf16* y2s = DS ? As + stages * MT_MAX * LDA : As;
  bf16* Bs = DS ? y2s + Pp * LD1 : As + max(stages * MT_MAX * LDA, Pp * LD1);
  bf16* zero8 = Bs + stages * KC * LDB_MAX;
  // 3x3 tap table: ktab[k / 8] = y1 offset of A column k = (dr*3 + dc)*Cm + j.
  int* ktab = reinterpret_cast<int*>(zero8 + 8);
  if (threadIdx.x < 8) zero8[threadIdx.x] = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 9 * p.Cm / 8; i += THREADS) {
    const int tap = i * 8 / p.Cm;
    ktab[i] = ((tap / 3) * TCin + tap % 3) * LD1 + i * 8 - tap * p.Cm;
  }

  int bid = blockIdx.x;
  const int tc = bid % p.tiles_c;
  bid /= p.tiles_c;
  const int tr = bid % p.tiles_r;
  const int b = bid / p.tiles_r;
  const int r0 = tr * p.TR;
  const int c0 = tc * p.TC;
  const int hi0 = r0 * S - 1;  // input row of halo row 0
  const int wi0 = c0 * S - 1;
  const int64_t img = static_cast<int64_t>(b) * p.H * p.W;
  const int64_t img_out = static_cast<int64_t>(b) * p.Ho * p.Wo;
  const bf16* __restrict__ x = p.x;

  // NHWC pixel of halo row m, or -1 outside the image.
  auto halo_pixel = [&](int m) -> int64_t {
    if (m >= M1) return -1;
    const int h = hi0 + m / TCin;
    const int w = wi0 + m % TCin;
    if (h < 0 || h >= p.H || w < 0 || w >= p.W) return -1;
    return img + static_cast<int64_t>(h) * p.W + w;
  };
  auto staged_base = [](int m) { return m * LDA; };
  auto staged_ptr = [&](int buf, int base, int k) {
    return As + buf * MT_MAX * LDA + base + (k & (KC - 1));
  };
  Acc acc;

  // 1. y1 on the halo window, zero outside the image.
  for (int mb = 0; mb < M1; mb += MT_MAX) {
    const int rows = min(MT_MAX, M1p - mb);
    const int strips = rows / 16;
    const StagedX stage_x(As, x, p.C, rows, [&](int m) { return halo_pixel(mb + m); });
    SSG_PASS(rows, {
      for (int n0 = 0; n0 < p.Cm; n0 += Grid<WC>::NC) {
        zero_acc(acc);
        mma_pass<WC>(acc, strips, p.C, p.w1, p.Cm, n0, Bs, zero8, stages, stage_x, staged_base,
                     staged_ptr);
        epilogue<WC>(acc, strips, n0, [&](int m, int n, float v0, float v1) {
          if (n >= p.Cm) return;
          const bool in = halo_pixel(mb + m) >= 0;
          store2(y1s + (mb + m) * LD1 + n, in ? fmaxf(v0 + p.b1[n], 0.f) : 0.f,
                 in ? fmaxf(v1 + p.b1[n + 1], 0.f) : 0.f);
        });
      }
    })
  }
  __syncthreads();

  // 2. y2 = relu(conv3x3_s(y1) + b2): A[m, (dr*3 + dc)*Cm + j] =
  // y1[(r*S + dr)*TCin + c*S + dc, j] for output pixel m = (r, c).
  {
    const int strips = Pp / 16;
    auto row_base = [&](int m) {
      if (m >= P) m = 0;  // padding rows: any finite row
      return (m / p.TC * S * TCin + m % p.TC * S) * LD1;
    };
    auto a_ptr = [&](int, int base, int k) { return y1s + base + ktab[k >> 3]; };
    SSG_PASS(Pp, {
      for (int n0 = 0; n0 < p.Cm; n0 += Grid<WC>::NC) {
        zero_acc(acc);
        mma_pass<WC>(acc, strips, 9 * p.Cm, p.w2, p.Cm, n0, Bs, zero8, stages, [](int, int) {},
                     row_base, a_ptr);
        epilogue<WC>(acc, strips, n0, [&](int m, int n, float v0, float v1) {
          if (n >= p.Cm) return;
          store2(y2s + m * LD1 + n, fmaxf(v0 + p.b2[n], 0.f), fmaxf(v1 + p.b2[n + 1], 0.f));
        });
      }
    })
  }
  __syncthreads();

  // 3. out = relu(y2 @ w3 + b3 + residual).
  {
    const int strips = Pp / 16;
    // Output pixel of tile row m (NHWC offset in out), or -1.
    auto out_pixel = [&](int m) -> int64_t {
      if (m >= P) return -1;
      const int r = r0 + m / p.TC;
      const int c = c0 + m % p.TC;
      if (r >= p.Ho || c >= p.Wo) return -1;
      return img_out + static_cast<int64_t>(r) * p.Wo + c;
    };
    auto y2_base = [&](int m) { return m * LD1; };
    auto y2_ptr = [&](int, int base, int k) { return y2s + base + k; };
    // The strided residual x[r*S, c*S], staged like x in phase 1 (DS only).
    const StagedX stage_xs(As, x, p.C, DS ? Pp : 0, [&](int m) -> int64_t {
      if (out_pixel(m) < 0) return -1;
      return img + static_cast<int64_t>((r0 + m / p.TC) * S) * p.W + (c0 + m % p.TC) * S;
    });
    SSG_PASS(Pp, {
      for (int n0 = 0; n0 < p.Cout; n0 += Grid<WC>::NC) {
        // The pass's residual (identity: x at the output pixels) is loaded
        // before its K loop, so the loads' latency hides behind the products.
        __nv_bfloat162 res[MAX_STRIPS][4][2];
        if constexpr (!DS) {
          for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
            const int64_t pix = out_pixel(m);
            res[s][t][h] = pix < 0 || n >= p.Cout
                               ? __floats2bfloat162_rn(0.f, 0.f)
                               : *reinterpret_cast<const __nv_bfloat162*>(x + pix * p.C + n);
          });
        }
        zero_acc(acc);
        mma_pass<WC>(acc, strips, p.Cm, p.w3, p.Cout, n0, Bs, zero8, stages, [](int, int) {}, y2_base,
                     y2_ptr);
        if constexpr (DS) {
          mma_pass<WC>(acc, strips, p.C, p.wd, p.Cout, n0, Bs, zero8, stages, stage_xs, staged_base,
                       staged_ptr);
        }
        for_each_pair<WC>(strips, n0, [&](int s, int t, int h, int m, int n) {
          const int64_t pix = out_pixel(m);
          if (pix < 0 || n >= p.Cout) return;
          float r0v, r1v;
          if constexpr (DS) {
            r0v = p.bd[n];
            r1v = p.bd[n + 1];
          } else {
            r0v = __bfloat162float(res[s][t][h].x);
            r1v = __bfloat162float(res[s][t][h].y);
          }
          store2(p.out + pix * p.Cout + n, fmaxf(acc[s][t][2 * h] + p.b3[n] + r0v, 0.f),
                 fmaxf(acc[s][t][2 * h + 1] + p.b3[n + 1] + r1v, 0.f));
        });
      }
    })
  }
}

#undef SSG_PASS

int smem_bytes(int TR, int TC, int S, bool ds, int Cm, int stages) {
  const int M1p = round16(((TR - 1) * S + 3) * ((TC - 1) * S + 3));
  const int y2 = round16(TR * TC) * (Cm + PAD);
  const int ring_a = stages * MT_MAX * LDA;
  return (M1p * (Cm + PAD) + (ds ? ring_a + y2 : (ring_a > y2 ? ring_a : y2)) +
          stages * KC * LDB_MAX + 8) * 2 + 9 * Cm / 8 * 4;
}

// Output tile of a block: at most cap pixels (full output width where it
// fits, then as many rows as fit), shrunk until its shared memory fits with
// the deepest ring, then evened out so the ragged last tile wastes as little
// as the tile count allows. cap starts at 128 and halves, down to 32, while
// the grid has fewer blocks than the 132 SMs of an H100. The ring is the
// deepest that lets two blocks share an SM, else the deepest: measured on
// an H100, a second resident block beats a deeper ring.
bool plan(int B, int Ho, int Wo, int S, bool ds, int Cm, int* TR, int* TC, int* stages) {
  for (int cap = P_MAX;; cap /= 2) {
    int tc = Wo < cap ? Wo : cap;
    int tr = Ho < cap / tc ? Ho : cap / tc;
    while (smem_bytes(tr, tc, S, ds, Cm, MAX_STAGES) > SMEM_LIMIT) {
      if (tr > 1) --tr;
      else if (tc > 1) --tc;
      else return false;
    }
    const int tiles_r = (Ho + tr - 1) / tr;
    const int tiles_c = (Wo + tc - 1) / tc;
    *TR = (Ho + tiles_r - 1) / tiles_r;
    *TC = (Wo + tiles_c - 1) / tiles_c;
    *stages = MAX_STAGES;
    for (int st = MAX_STAGES; st >= 2; --st) {
      if (smem_bytes(*TR, *TC, S, ds, Cm, st) <= SMEM_TWO_PER_SM) {
        *stages = st;
        break;
      }
    }
    if (static_cast<int64_t>(B) * tiles_r * tiles_c >= 132 || cap <= 32) return true;
  }
}

// fp32 blocks. The TPU kernel takes fp32 activations too (its products take
// x.dtype), and mma.sync has no fp32 form, so an fp32 block is a run of
// conv_f32_kernel launches, a tiled implicit GEMM on the fp32 FMA units: y1,
// y2 and a downsample block's residual pass through device memory. Right and
// simple first: no path runs fp32 blocks at speed.
constexpr int F_BM = 64;  // output pixels of a block
constexpr int F_BN = 64;  // output channels of a block
constexpr int F_BK = 16;  // K per staged chunk

struct ConvF32 {
  const float* in;    // (B, H, W, Cin) NHWC
  const float* w;     // (R * R * Cin, Cout) row-major (HWIO flattened)
  const float* bias;  // (Cout,)
  const float* res;   // (B, Ho, Wo, Cout) added before the ReLU, or nullptr
  float* out;         // (B, Ho, Wo, Cout)
  int B, H, W, Cin, Ho, Wo, Cout, R, S;
  bool relu;
};

// out[m, n] = act(sum_k A[m, k] w[k, n] + bias[n] + res[m, n]), where output
// pixel m = (b, ho, wo), k = (dr * R + dc) * Cin + ci and A[m, k] =
// in[b, ho * S + dr - R / 2, wo * S + dc - R / 2, ci], zero outside the image.
// 256 threads hold a 64 x 64 tile, 4 x 4 outputs each, strided by 16.
__global__ void __launch_bounds__(THREADS) conv_f32_kernel(const ConvF32 p) {
  __shared__ float As[F_BK][F_BM + 4];
  __shared__ float Bs[F_BK][F_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t M = static_cast<int64_t>(p.B) * p.Ho * p.Wo;
  const int K = p.R * p.R * p.Cin;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * F_BM;
  const int n0 = blockIdx.y * F_BN;
  const int pad = p.R / 2;

  // This thread stages A row a_row, columns a_k .. a_k + 3 of each chunk.
  const int a_row = tid / 4;
  const int a_k = tid % 4 * 4;
  const int64_t am = m0 + a_row;
  int64_t a_img = -1;  // NHWC offset of image b, or -1 past the last pixel
  int a_h = 0, a_w = 0;
  if (am < M) {
    const int wo = static_cast<int>(am % p.Wo);
    const int64_t t = am / p.Wo;
    a_h = static_cast<int>(t % p.Ho) * p.S - pad;
    a_w = wo * p.S - pad;
    a_img = t / p.Ho * p.H * p.W;
  }
  // ... and B row b_row, columns b_n .. b_n + 3.
  const int b_row = tid / 16;
  const int b_n = tid % 16 * 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + a_k + e;
      float v = 0.f;
      if (a_img >= 0 && k < K) {
        const int tap = k / p.Cin;
        const int h = a_h + tap / p.R;
        const int w = a_w + tap % p.R;
        if (h >= 0 && h < p.H && w >= 0 && w < p.W)
          v = p.in[(a_img + static_cast<int64_t>(h) * p.W + w) * p.Cin + k - tap * p.Cin];
      }
      As[a_k + e][a_row] = v;
      const int k_b = k0 + b_row;
      const int n = n0 + b_n + e;
      Bs[b_row][b_n + e] = k_b < K && n < p.Cout ? p.w[static_cast<int64_t>(k_b) * p.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.Cout) continue;
      float v = acc[i][j] + p.bias[n];
      if (p.res != nullptr) v += p.res[m * p.Cout + n];
      p.out[m * p.Cout + n] = p.relu ? fmaxf(v, 0.f) : v;
    }
  }
}

cudaError_t conv_f32(const float* in, const float* w, const float* bias, const float* res,
                     float* out, int B, int H, int W, int Cin, int Cout, int R, int S, bool relu,
                     cudaStream_t stream) {
  const ConvF32 p{in, w, bias, res, out, B, H, W, Cin, (H - 1) / S + 1, (W - 1) / S + 1, Cout,
                  R, S, relu};
  const int64_t tiles = (static_cast<int64_t>(B) * p.Ho * p.Wo + F_BM - 1) / F_BM;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  conv_f32_kernel<<<dim3(static_cast<unsigned>(tiles), (Cout + F_BN - 1) / F_BN), THREADS, 0,
                    stream>>>(p);
  return cudaGetLastError();
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
  int TR, TC, stages;
  if (!plan(static_cast<int>(B), Ho, Wo, static_cast<int>(stride), ds != 0, static_cast<int>(Cm),
            &TR, &TC, &stages))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = TR;
  out[1] = TC;
  out[2] = B * ((Ho + TR - 1) / TR) * ((Wo + TC - 1) / TC);
  out[3] = smem_bytes(TR, TC, static_cast<int>(stride), ds != 0, static_cast<int>(Cm), stages);
  out[4] = stages;
  return 0;
}

// x (B, H, W, C), out (B, Ho, Wo, Cout) with Ho = ceil(H / stride): bf16,
// NHWC-contiguous. w1 (C, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, Cout), wd (C, Cout):
// bf16 row-major; b1, b2 (Cm,), b3, bd (Cout,): fp32. wd == nullptr selects
// the identity block (stride 1, Cout == C). C, Cm, Cout multiples of 8;
// pointers 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ssg_bottleneck(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, const void* w3, const float* b3, const void* wd,
                              const float* bd, void* out, int64_t B, int64_t H, int64_t W,
                              int64_t C, int64_t Cm, int64_t Cout, int64_t stride, void* stream) {
  const bool ds = wd != nullptr;
  if ((stride != 1 && stride != 2) || (!ds && (stride != 1 || Cout != C)) || C % 8 || Cm % 8 ||
      Cout % 8 || B <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = b1;
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = b2;
  p.w3 = static_cast<const bf16*>(w3);
  p.b3 = b3;
  p.wd = static_cast<const bf16*>(wd);
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
  if (!plan(p.B, p.Ho, p.Wo, static_cast<int>(stride), ds, p.Cm, &p.TR, &p.TC, &p.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_r = (p.Ho + p.TR - 1) / p.TR;
  p.tiles_c = (p.Wo + p.TC - 1) / p.TC;
  const int64_t blocks = B * p.tiles_r * p.tiles_c;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = smem_bytes(p.TR, p.TC, static_cast<int>(stride), ds, p.Cm, p.stages);
  void (*kernel)(const Params) = !ds ? bottleneck_kernel<1, false>
                                 : stride == 1 ? bottleneck_kernel<1, true>
                                               : bottleneck_kernel<2, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The same block in fp32: every tensor fp32, NHWC-contiguous, plus device
// workspaces y1 (B, H, W, Cm), y2 (B, Ho, Wo, Cm) and, for a downsample
// block, res (B, Ho, Wo, Cout). Launches conv_f32_kernel three times (four
// for a downsample block) on `stream`; returns the first CUDA error, or 0.
extern "C" int ssg_bottleneck_f32(const float* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* w3,
                                  const float* b3, const float* wd, const float* bd, float* out,
                                  float* y1, float* y2, float* res, int64_t B, int64_t H,
                                  int64_t W, int64_t C, int64_t Cm, int64_t Cout, int64_t stride,
                                  void* stream) {
  const bool ds = wd != nullptr;
  if ((stride != 1 && stride != 2) || (!ds && (stride != 1 || Cout != C)) || B <= 0 || H <= 0 ||
      W <= 0 || C <= 0 || Cm <= 0 || Cout <= 0 || B * H * W > 2147483647LL)
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
