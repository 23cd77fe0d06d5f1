// All-pairs squared (or plain) Euclidean distance, fp32:
//   out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0)   (then sqrt if !squared)
//
// Replaces the TPU kernel ssg_tpu/ops/distance.py:_dist_kernel (launched by
// _pairwise_pallas, the opt-in impl="pallas"). It is the distance the
// re-ranking starts from: (N, D) x (N, D) -> (N, N) with N = 3368 and
// D = 2048 per feature group on the main path.
//
// Bound on an H100: operations. The contract is the JAX package's
// Precision.HIGHEST product, so the tensor cores (TF32 at most) do not
// apply: 2 * 3368^2 * 2048 = 46.5 GFLOP on the fp32 FMA pipes at 67 TFLOP/s
// is 0.69 ms, against ~0.03 ms to read x and y and write out once.
//
// Design (simple and right first, the layout of l1.cu with an FMA in place
// of |a - b|): each block owns a 128 x 128 output tile and walks K itself,
// staging 16-wide slabs of x and y through shared memory, k-major. Each of
// the 256 threads keeps an 8 x 8 register accumulator over 8 consecutive
// rows and 8 consecutive columns, read from shared memory as float4. The
// norms are fused into the same K loop: thread t < 128 sums the squares of
// x-tile row t, thread t >= 128 those of y-tile row t - 128, from the slab
// already in shared memory (16 FMAs a slab against 1024 for the product).
// Ragged M, N and D are masked here: out-of-range elements load as 0, which
// adds nothing to any term.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int TX = BN / TN;        // 16 threads across columns
constexpr int TY = BM / TM;        // 16 threads across rows
constexpr int THREADS = TX * TY;   // 256
constexpr int LDS = BM + 4;        // float4-aligned rows, staggered banks

// Two blocks an SM (at most 128 registers a thread): one block of 8 warps
// leaves the FMA pipes waiting on shared-memory loads.
__global__ void __launch_bounds__(THREADS, 2)
dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int64_t M, int64_t N, int64_t D,
            int64_t ldx, int64_t ldy, int64_t ldo, int squared) {
  __shared__ __align__(16) float xs[BK][LDS];
  __shared__ __align__(16) float ys[BK][LDS];
  __shared__ float xn[BM];
  __shared__ float yn[BN];

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
  float norm = 0.f;

  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    // 128 rows x 16 k of each operand; 16 neighbouring threads read 16
    // consecutive k of one row (64 bytes).
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

    if (tid < BM) {
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(xs[k][tid], xs[k][tid], norm);
    } else {
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(ys[k][tid - BM], ys[k][tid - BM], norm);
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[k][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ys[k][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) xn[tid] = norm;
  else yn[tid - BM] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float d = fmaxf(xn[ty * TM + i] + yn[tx * TN + j] - 2.f * acc[i][j], 0.f);
      out[gm * ldo + gn] = squared ? d : sqrtf(d);
    }
  }
}

}  // namespace

// x (M, D), y (N, D), out (M, N): fp32, unit stride along the last axis,
// row strides ldx / ldy / ldo in elements. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ssg_pairwise_distance(const float* x, const float* y, float* out, int64_t M,
                                     int64_t N, int64_t D, int64_t ldx, int64_t ldy,
                                     int64_t ldo, int squared, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int64_t grid_m = (M + BM - 1) / BM;
  const int64_t grid_n = (N + BN - 1) / BN;
  if (grid_m > 65535 || grid_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(grid_n), static_cast<unsigned>(grid_m));
  dist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, M, N, D, ldx, ldy, ldo, squared);
  return static_cast<int>(cudaGetLastError());
}
