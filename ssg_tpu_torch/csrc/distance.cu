// All-pairs squared (or plain) Euclidean distance, fp32:
//   out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0)   (then sqrt if !squared)
//
// Replaces the TPU kernel ssg_tpu/ops/distance.py:_dist_kernel (launched by
// _pairwise_pallas, the opt-in impl="pallas"). It is the distance the
// re-ranking starts from: (N, D) against itself -> (N, N) with N = 3368 and
// D = 2048 per feature group on the path.
//
// Bound on an H100: operations. The contract is the JAX package's
// Precision.HIGHEST product, i.e. fp32 accuracy. The way to the tensor cores
// at that accuracy is 3xTF32: a = a_hi + a_lo with both halves TF32, and
// a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (a_lo.b_lo, ~2^-22 of the product,
// is dropped), accumulated in fp32. At N = 3368, D = 2048 a symmetric call
// needs N(N+1)/2 pairs: 3 x 23.2 GFLOP on the TF32 tensor cores (495
// TFLOP/s) is 0.141 ms, against 0.347 ms for the same pairs on the fp32 FMA
// pipes (67 TFLOP/s) and ~0.02 ms to read x and write out once.
//
// Design. A block owns a 128 x 128 output tile and walks K itself: 32-wide
// slabs of its 128 x rows and 128 y rows arrive by cp.async (16 bytes a
// thread where rows allow it) in a 4-slot ring, K-major with rows padded to
// 36 floats so that ldmatrix rows fall on distinct banks; one block barrier a
// slab. Eight warps each hold 64 x 32 outputs. Per 8-deep k step a warp loads
// its fragments with ldmatrix (a 32-bit element is a pair of b16, so the tf32
// A and B fragments of mma.m16n8k8 come out as they are), splits each with
// cvt.rna.tf32 into hi and lo, and issues three mma.sync m16n8k8 tf32 a
// fragment pair into a per-slab partial sum, which fp32 adds fold into the
// accumulator (the tensor cores' accumulation is not round-to-nearest). The
// two sets of 64 sums take one block an SM (378 tiles: 2.9 waves at N =
// 3368). The norms are fused into the same K loop: thread t sums the squares
// of slab row t (128 x rows, then 128 y rows), 32 k in fp32, then the slabs'
// sums in fp64: a norm error shifts a whole column of distances, and one
// fp32 chain over D = 2048 squares misses by ~1e-6 of |x|^2.
//
// Symmetric calls (y is x, every call on the path): only tiles with
// tile_j >= tile_i are launched. The epilogue stages the tile in the ring and
// writes it, then, off the diagonal, its transpose, both as coalesced row
// stores; a diagonal tile writes its lower triangle from its upper one. So the
// output is exactly symmetric, with every entry the kernel's value for i <= j.
// Ragged M, N and D are masked here: out-of-range elements load as 0, which
// adds nothing to any term.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // tile rows (x rows) = tile columns (y rows)
constexpr int BK = 32;             // k per staged slab
constexpr int STAGES = 4;          // cp.async ring slots
constexpr int LDS = BK + 4;        // slab row stride in floats (144 bytes)
constexpr int SLAB = 2 * BM * LDS;  // one slot: 128 x rows, then 128 y rows
constexpr int THREADS = 256;       // 8 warps: 2 across rows x 4 across columns
constexpr int WM = 64;             // rows a warp
constexpr int WN = 32;             // columns a warp
constexpr int MT = WM / 16;        // m16 fragments a warp
constexpr int NT = WN / 8;         // n8 fragments a warp
constexpr int LDT = BM + 1;        // staged output tile row stride
constexpr int SMEM_BYTES = STAGES * SLAB * 4;  // 147,456: one block an SM
static_assert(BM * LDT <= STAGES * SLAB, "the output tile is staged in the ring");

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
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
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

// Output tile of block b: row-major over the full grid, or the b-th tile of
// the upper triangle (tile_j >= tile_i, row by row) in a symmetric call.
__device__ __forceinline__ void tile_of(int b, int tiles_n, int symmetric, int& ti, int& tj) {
  if (!symmetric) {
    ti = b / tiles_n;
    tj = b % tiles_n;
    return;
  }
  ti = 0;
  while (b >= tiles_n - ti) {
    b -= tiles_n - ti;
    ++ti;
  }
  tj = ti + b;
}

// BK k of BM rows g0.. of src (G rows, row stride ld) into dst; 8 (or 32)
// neighbouring threads read one row's 128 bytes. One pointer a thread, so
// the copies hold few registers beside the accumulators.
template <int VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t g0, int64_t G,
                                          int64_t ld, int64_t k0, int64_t D, int tid) {
  constexpr int PER_ROW = BK / VEC;
  constexpr int STEP = THREADS / PER_ROW;  // rows a pass
  const int r0 = tid / PER_ROW;
  const int k = (tid % PER_ROW) * VEC;
  const bool k_valid = k0 + k < D;
  const float* p = src + (g0 + r0) * ld + k0 + k;
#pragma unroll
  for (int it = 0; it < BM / STEP; ++it) {
    const bool valid = k_valid && g0 + r0 + it * STEP < G;
    cp_async<VEC>(dst + (r0 + it * STEP) * LDS + k, valid ? p + it * STEP * ld : src, valid);
  }
}

// One slot: the tile's 128 x rows (slab rows 0..127), then its 128 y rows.
template <int VEC>
__device__ __forceinline__ void load_slab(float* slot, const float* x, const float* y,
                                          int64_t m0, int64_t n0, int64_t k0, int64_t M,
                                          int64_t N, int64_t D, int64_t ldx, int64_t ldy,
                                          int tid) {
  load_rows<VEC>(slot, x, m0, M, ldx, k0, D, tid);
  load_rows<VEC>(slot + BM * LDS, y, n0, N, ldy, k0, D, tid);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
dist_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
            int64_t M, int64_t N, int64_t D, int64_t ldx, int64_t ldy, int64_t ldo,
            int tiles_n, int symmetric, int squared) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float xn[BM];
  __shared__ float yn[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / (BM / WN);
  const int wn = warp % (BM / WN);
  int ti, tj;
  tile_of(blockIdx.x, tiles_n, symmetric, ti, tj);
  const int64_t m0 = static_cast<int64_t>(ti) * BM;
  const int64_t n0 = static_cast<int64_t>(tj) * BM;
  const int kt_end = static_cast<int>((D + BK - 1) / BK);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  double norm = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_end)
      load_slab<VEC>(smem + s * SLAB, x, y, m0, n0, int64_t{s} * BK, M, N, D, ldx, ldy, tid);
    cp_async_commit();
  }

  // ldmatrix row of this lane. A (16 rows x 8 k): matrices rows 0-7 / 8-15
  // at k 0-3, then at k 4-7 = a0..a3. B (two n8 fragments x 8 k): n 0-7 at
  // k 0-3 / 4-7, then n 8-15 = b0, b1 of the first, b0, b1 of the second.
  const float* a_lane = smem + (wm * WM + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 4;
  const float* b_lane = smem + (BM + wn * WN + (lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 4;

  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // Refill the slot that step kt - 1 used: every thread is past it.
    const int nk = kt + STAGES - 1;
    if (nk < kt_end)
      load_slab<VEC>(smem + (nk % STAGES) * SLAB, x, y, m0, n0, int64_t{nk} * BK, M, N, D,
                     ldx, ldy, tid);
    cp_async_commit();

    const int slot = (kt % STAGES) * SLAB;
    const float4* row = reinterpret_cast<const float4*>(smem + slot + tid * LDS);
    float slab_norm = 0.f;
#pragma unroll
    for (int q = 0; q < BK / 4; ++q) {
      const float4 v = row[q];
      slab_norm = fmaf(v.x, v.x, slab_norm);
      slab_norm = fmaf(v.y, v.y, slab_norm);
      slab_norm = fmaf(v.z, v.z, slab_norm);
      slab_norm = fmaf(v.w, v.w, slab_norm);
    }
    norm += slab_norm;

    // This slab's products go into part, then into acc by fp32 adds: the
    // tensor cores' own fp32 accumulation does not round to nearest, and
    // over 3 x 256 steps into one accumulator (D = 2048) its bias reached
    // ~2e-5 of |x|^2 on an H100. part takes only a slab's 12 steps.
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, b_lane + slot + p * 16 * LDS + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(b[q], bhi[2 * p + q / 2][q % 2], blo[2 * p + q / 2][q % 2]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4], ahi[4], alo[4];
        ldsm_x4(a, a_lane + slot + i * 16 * LDS + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(a[q], ahi[q], alo[q]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(part[i][j], alo, bhi[j][0], bhi[j][1]);
          mma_tf32(part[i][j], ahi, blo[j][0], blo[j][1]);
          mma_tf32(part[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }

  cp_async_wait<0>();
  if (tid < BM) xn[tid] = static_cast<float>(norm);
  else yn[tid - BM] = static_cast<float>(norm);
  __syncthreads();  // the ring is free and the norms are in

  // Stage the tile: fragment element c of (i, j) is row gid (+8 for c >= 2),
  // column 2 tig + (c & 1).
  float* tile = smem;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm * WM + i * 16 + gid + (c >> 1) * 8;
        const int col = wn * WN + j * 8 + 2 * tig + (c & 1);
        const float d = fmaxf(xn[r] + yn[col] - 2.f * acc[i][j][c], 0.f);
        tile[r * LDT + col] = squared ? d : sqrtf(d);
      }
  __syncthreads();

  const bool diag = symmetric && ti == tj;
  for (int idx = tid; idx < BM * BM; idx += THREADS) {
    const int r = idx / BM;
    const int c = idx % BM;
    if (m0 + r < M && n0 + c < N)
      out[(m0 + r) * ldo + n0 + c] = diag && r > c ? tile[c * LDT + r] : tile[r * LDT + c];
  }
  if (symmetric && !diag) {
    for (int idx = tid; idx < BM * BM; idx += THREADS) {
      const int c = idx / BM;
      const int r = idx % BM;
      if (n0 + c < N && m0 + r < M) out[(n0 + c) * ldo + m0 + r] = tile[r * LDT + c];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (M, D), y (N, D), out (M, N): fp32, unit stride along the last axis,
// row strides ldx / ldy / ldo in elements. symmetric != 0 says that y is x
// (then M == N and ldx == ldy): only the upper triangle of tiles is computed,
// and mirrored. Launches on `stream` and returns a CUDA error code (0 on
// success); does not synchronise.
extern "C" int ssg_pairwise_distance(const float* x, const float* y, float* out, int64_t M,
                                     int64_t N, int64_t D, int64_t ldx, int64_t ldy,
                                     int64_t ldo, int symmetric, int squared, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (symmetric && (x != y || M != N || ldx != ldy))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_m = (M + BM - 1) / BM;
  const int64_t tiles_n = (N + BM - 1) / BM;
  const int64_t blocks = symmetric ? tiles_m * (tiles_m + 1) / 2 : tiles_m * tiles_n;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = D % 4 == 0 && ldx % 4 == 0 && ldy % 4 == 0 && aligned16(x) && aligned16(y);
  const auto kernel = vec ? &dist_kernel<4> : &dist_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, M, N, D, ldx, ldy, ldo, static_cast<int>(tiles_n), symmetric, squared);
  return static_cast<int>(cudaGetLastError());
}
