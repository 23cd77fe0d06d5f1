// All-pairs L1 (Manhattan) distance, fp32: out[i, j] = sum_k |x[i, k] - y[j, k]|.
//
// Replaces the TPU kernel ssg_tpu/ops/l1.py:_l1_kernel (launched by
// _l1_pallas). On the main path it is the Jaccard min-sum of the
// k-reciprocal re-ranking, over the sparse encoding V against itself:
// (N, N) -> (N, N) with N = 3368, once per feature group.
//
// Bound on an H100: operations. Each pair of elements costs two fp32
// instructions (subtract, then add with the |.| operand modifier); there is
// no FMA and no tensor-core form. At 132 SMs x 128 lanes x ~1.98 GHz =
// 33.5e12 instructions/s, the N(N+1)/2 pairs of a symmetric call at
// N = D = 3368 take 1.14 ms (2.28 ms for the full matrix), against ~0.03 ms
// to read V and write out once.
//
// Design: keep the FP32 pipes, not shared-memory loads, the limit, and
// compute each pair once. A block of 128 threads owns a work unit of
// 16 TM rows x 64 columns and walks K itself. 32-wide slabs of its x rows
// and y rows arrive by cp.async (16 bytes a thread where rows allow it) in a
// 2-slot ring, row-major with rows padded to 36 floats; one block barrier a
// slab. Thread (ty, tx) holds rows ty + 16 i (i < TM) and columns tx + 8 j
// (j < 8), and reads both as float4 along k: per 4 k, TM + 8 LDS.128 for
// 8 TM x 4 pairs, 1:32 at TM = 8 (the 4x4 scalar tile before it issued one
// LDS a 4 FP instructions). Every output sums its k in order 0..D-1, as the
// kernel it replaces did, so the two give the same bits. TM = 8 (128 x 64
// units, three blocks an SM) when the grid gives every SM at least two units;
// smaller grids take TM = 4 (64 x 64), and general calls too small to give
// every SM one of those TM = 2 (32 x 64), so that more SMs and warps work.
//
// Symmetric calls (y is x, every call on the path): the units tile the upper
// triangle of 16 TM-square tiles, each split into 16 TM / 64 column units
// (at N = 3368 and TM = 8: 378 tiles, 756 units, 5.7 an SM, three at a
// time). Off the diagonal a unit writes its tile part and the transpose,
// staged in the ring so that both are coalesced row stores. |a - b| = |b - a|
// and the k order is the same, so the output is exactly symmetric.
// Ragged M, N and D are masked here: out-of-range x/y elements load as 0,
// which is exact for the K padding (|0 - 0| = 0) and never stored for the
// M/N padding.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;             // unit columns (y rows)
constexpr int BK = 32;             // k per staged slab
constexpr int STAGES = 2;          // cp.async ring slots
constexpr int LDS = BK + 4;        // slab row stride in floats: rows 1 apart on other banks
constexpr int TN = 8;              // columns a thread
constexpr int TX = BN / TN;        // 8 threads across columns
constexpr int TY = 16;             // threads across rows
constexpr int THREADS = TX * TY;   // 128
constexpr int LDT = BN + 1;        // staged output row stride

template <int TM>
struct Unit {
  static constexpr int BM = TY * TM;               // unit rows (x rows)
  static constexpr int SLAB = (BM + BN) * LDS;     // one slot: x rows, then y rows
  static constexpr int SMEM_BYTES = STAGES * SLAB * 4;  // 55,296 at TM = 8
  static_assert(BM * LDT <= STAGES * SLAB, "the output is staged in the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC floats global -> shared; zero-filled when !valid (src is then not read).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// BK k of ROWS rows g0.. of src (G rows, row stride ld) into dst; 8 (or
// 32) neighbouring threads read one row's 128 bytes. One pointer a thread,
// so the copies hold few registers beside the accumulators.
template <int ROWS, int VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t g0, int64_t G,
                                          int64_t ld, int64_t k0, int64_t D, int tid) {
  constexpr int PER_ROW = BK / VEC;
  constexpr int STEP = THREADS / PER_ROW;  // rows a pass
  const int r0 = tid / PER_ROW;
  const int k = (tid % PER_ROW) * VEC;
  const bool k_valid = k0 + k < D;
  const float* p = src + (g0 + r0) * ld + k0 + k;
#pragma unroll
  for (int it = 0; it < ROWS / STEP; ++it) {
    const bool valid = k_valid && g0 + r0 + it * STEP < G;
    cp_async<VEC>(dst + (r0 + it * STEP) * LDS + k, valid ? p + it * STEP * ld : src, valid);
  }
}

// One slot: the unit's BM x rows, then its BN y rows.
template <int TM, int VEC>
__device__ __forceinline__ void load_slab(float* slot, const float* x, const float* y,
                                          int64_t m0, int64_t n0, int64_t k0, int64_t M,
                                          int64_t N, int64_t D, int64_t ldx, int64_t ldy,
                                          int tid) {
  constexpr int BM = Unit<TM>::BM;
  load_rows<BM, VEC>(slot, x, m0, M, ldx, k0, D, tid);
  load_rows<BN, VEC>(slot + BM * LDS, y, n0, N, ldy, k0, D, tid);
}

// Work unit b -> its first row m0 and column n0. Full grid: row-major over
// units_n column units. Symmetric: tile b / H of the upper triangle of
// units_n BM-square tiles (row by row, tile_j >= tile_i), column part b % H.
template <int TM>
__device__ __forceinline__ void unit_of(int b, int units_n, int symmetric, int64_t& m0,
                                        int64_t& n0, bool& diag) {
  constexpr int BM = Unit<TM>::BM;
  constexpr int H = BM >= BN ? BM / BN : 1;  // symmetric calls take TM >= 4
  if (!symmetric) {
    m0 = static_cast<int64_t>(b / units_n) * BM;
    n0 = static_cast<int64_t>(b % units_n) * BN;
    diag = false;
    return;
  }
  int t = b / H;
  int ti = 0;
  while (t >= units_n - ti) {
    t -= units_n - ti;
    ++ti;
  }
  m0 = static_cast<int64_t>(ti) * BM;
  n0 = static_cast<int64_t>(ti + t) * BM + (b % H) * BN;
  diag = t == 0;
}

template <int TM, int VEC>
__global__ void __launch_bounds__(THREADS, 3)
l1_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
          int64_t M, int64_t N, int64_t D, int64_t ldx, int64_t ldy, int64_t ldo, int units_n,
          int symmetric) {
  constexpr int BM = Unit<TM>::BM;
  constexpr int SLAB = Unit<TM>::SLAB;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  int64_t m0, n0;
  bool diag;
  unit_of<TM>(blockIdx.x, units_n, symmetric, m0, n0, diag);
  const int kt_end = static_cast<int>((D + BK - 1) / BK);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (kt_end > 0) load_slab<TM, VEC>(smem, x, y, m0, n0, 0, M, N, D, ldx, ldy, tid);
  cp_async_commit();

  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    // Refill the other slot, which step kt - 1 used: every thread is past it.
    if (kt + 1 < kt_end)
      load_slab<TM, VEC>(smem + ((kt + 1) % STAGES) * SLAB, x, y, m0, n0, int64_t{kt + 1} * BK,
                         M, N, D, ldx, ldy, tid);
    cp_async_commit();

    const float* xs = smem + (kt % STAGES) * SLAB + ty * LDS;
    const float* ys = smem + (kt % STAGES) * SLAB + (BM + tx) * LDS;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(xs + i * TY * LDS + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(ys + j * TX * LDS + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] += fabsf(a[i].x - b.x);
          acc[i][j] += fabsf(a[i].y - b.y);
          acc[i][j] += fabsf(a[i].z - b.z);
          acc[i][j] += fabsf(a[i].w - b.w);
        }
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // the ring is free
  float* tile = smem;  // BM x BN, row stride LDT
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) tile[(ty + TY * i) * LDT + tx + TX * j] = acc[i][j];
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    if (m0 + r < M && n0 + c < N) out[(m0 + r) * ldo + n0 + c] = tile[r * LDT + c];
  }
  if (symmetric && !diag) {
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int c = idx / BM;
      const int r = idx % BM;
      if (n0 + c < N && m0 + r < M) out[(n0 + c) * ldo + m0 + r] = tile[r * LDT + c];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int TM>
int64_t units(int64_t M, int64_t N, int symmetric, int64_t& units_n) {
  constexpr int BM = Unit<TM>::BM;
  const int64_t tiles_m = (M + BM - 1) / BM;
  if (symmetric) {
    units_n = tiles_m;
    return tiles_m * (tiles_m + 1) / 2 * (BM / BN);
  }
  units_n = (N + BN - 1) / BN;
  return tiles_m * units_n;
}

template <int TM>
int launch(const float* x, const float* y, float* out, int64_t M, int64_t N, int64_t D,
           int64_t ldx, int64_t ldy, int64_t ldo, int symmetric, cudaStream_t stream) {
  int64_t units_n;
  const int64_t blocks = units<TM>(M, N, symmetric, units_n);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = D % 4 == 0 && ldx % 4 == 0 && ldy % 4 == 0 && aligned16(x) && aligned16(y);
  const auto kernel = vec ? &l1_kernel<TM, 4> : &l1_kernel<TM, 1>;
  constexpr int smem = Unit<TM>::SMEM_BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      x, y, out, M, N, D, ldx, ldy, ldo, static_cast<int>(units_n), symmetric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, D), y (N, D), out (M, N): fp32, unit stride along the last axis,
// row strides ldx / ldy / ldo in elements. symmetric != 0 says that y is x
// (then M == N and ldx == ldy): only the upper triangle of tiles is computed,
// and mirrored. Launches on `stream` and returns a CUDA error code (0 on
// success); does not synchronise.
extern "C" int ssg_l1_distance(const float* x, const float* y, float* out, int64_t M,
                               int64_t N, int64_t D, int64_t ldx, int64_t ldy, int64_t ldo,
                               int symmetric, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (symmetric && (x != y || M != N || ldx != ldy))
    return static_cast<int>(cudaErrorInvalidValue);
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t units_n;
  const auto s = static_cast<cudaStream_t>(stream);
  if (units<8>(M, N, symmetric, units_n) >= 2 * int64_t{sms})
    return launch<8>(x, y, out, M, N, D, ldx, ldy, ldo, symmetric, s);
  if (symmetric || units<4>(M, N, symmetric, units_n) >= sms)
    return launch<4>(x, y, out, M, N, D, ldx, ldy, ldo, symmetric, s);
  return launch<2>(x, y, out, M, N, D, ldx, ldy, ldo, symmetric, s);
}
