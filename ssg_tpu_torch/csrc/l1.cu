// All-pairs L1 (Manhattan) distance, fp32: out[i, j] = sum_k |x[i, k] - y[j, k]|.
//
// Replaces the TPU kernel ssg_tpu/ops/l1.py:_l1_kernel (launched by
// _l1_pallas). On the main path it is the Jaccard min-sum of the
// k-reciprocal re-ranking, over the sparse encoding V: (N, N) x (N, N) ->
// (N, N) with N = 3368, once per feature group.
//
// Bound on an H100: compute. Each of the M*N*D pairs costs two fp32
// instructions (subtract, then add with the |.| operand modifier); there
// is no FMA and no tensor-core form. At 132 SMs x 128 lanes x ~1.98 GHz
// = 33.5e12 instructions/s that is ~2.3 ms at N = D = 3368, against
// ~0.04 ms to read x and y and write out once.
//
// Design (simple and right first): each block owns a 64x64 output tile and
// walks K itself, staging 32-wide slabs of x and y through shared memory,
// stored k-major so the inner loop reads one row-value and one column-value
// per k. Each of the 256 threads keeps a 4x4 register accumulator over
// rows ty + 16 i and columns tx + 16 j, so shared-memory reads broadcast
// and output stores are coalesced. Ragged M, N and D are masked here:
// out-of-range x/y elements load as 0, which is exact for the K padding
// (|0 - 0| = 0) and never stored for the M/N padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;        // 16 threads across columns
constexpr int TY = BM / TM;        // 16 threads across rows
constexpr int THREADS = TX * TY;   // 256

__global__ void __launch_bounds__(THREADS)
l1_kernel(const float* __restrict__ x, const float* __restrict__ y,
          float* __restrict__ out, int64_t M, int64_t N, int64_t D,
          int64_t ldx, int64_t ldy, int64_t ldo) {
  // +1 column: the transposing store (a warp writes 32 k of one row) hits
  // 32 distinct banks.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    // 64 rows x 32 k of each operand; a warp reads 32 consecutive k of one
    // row (one 128-byte line).
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const int64_t gk = k0 + k;
      const int64_t gm = m0 + r;
      const int64_t gn = n0 + r;
      xs[k][r] = (gm < M && gk < D) ? x[gm * ldx + gk] : 0.f;
      ys[k][r] = (gn < N && gk < D) ? y[gn * ldy + gk] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += fabsf(a[i] - b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + TX * j;
      if (gn < N) out[gm * ldo + gn] = acc[i][j];
    }
  }
}

}  // namespace

// x (M, D), y (N, D), out (M, N): fp32, unit stride along the last axis,
// row strides ldx / ldy / ldo in elements. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ssg_l1_distance(const float* x, const float* y, float* out,
                               int64_t M, int64_t N, int64_t D, int64_t ldx,
                               int64_t ldy, int64_t ldo, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int64_t grid_m = (M + BM - 1) / BM;
  const int64_t grid_n = (N + BN - 1) / BN;
  if (grid_m > 65535 || grid_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(grid_n), static_cast<unsigned>(grid_m));
  l1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, M, N, D, ldx, ldy, ldo);
  return static_cast<int>(cudaGetLastError());
}
