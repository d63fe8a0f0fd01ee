// Multi-threshold activation on Hopper:
//   codes[m, n] = sum_l [ float(acc[m, n]) * sign[n] >= thr[n, l] ].
//
// Replaces the Pallas kernel threshold_pallas
// (src/repro/kernels/thresholds/kernel.py:31, body _threshold_body :21),
// the paper's multi-threshold unit (Sec. 3.2): batch norm, ReLU6 and the
// next layer's quantizer folded into L integer thresholds per channel.
//
// Layout: acc [M, N] int32 row-major (the LUT kernel's output), thr [N, L]
// float32, sign [N] float32, codes [M, N] int32.  Every level is counted,
// as the reference counts it: rows need not be sorted, +inf never counts,
// a NaN threshold never counts (an ordered >= is false on NaN).  The
// product is one IEEE multiply (__int2float_rn rounds an |acc| above 2^24
// to nearest even, as the CPU's conversion does; __fmul_rn is never fused).
//
// Bound: an elementwise pass over device memory, (8*M*N + 4*N*(L+1)) bytes
// over 3.35 TB/s.  At batch 32 the 34 pointwise stages of MobileNetV2
// (224x224) move 1.02 GB, 0.30 ms a pass; the largest, b1_0_expand (M =
// 401,408, N = 96), 0.092 ms.  What the design does about it: a block takes
// a tile of 32 columns, one per lane, so a warp reads and writes 128
// contiguous bytes of a row; it loads the tile's thresholds once into
// shared memory as [L][32], so the 32 lanes of a warp read 32 neighbouring
// banks for each level, and its signs; then each thread walks rows of its
// column with a grid-stride loop.  The L compares per element come out of
// shared memory and registers, never device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BN = 32;                   // columns per block, one per lane
constexpr int ROWS = 8;                  // warps per block, a row each
constexpr int THREADS = BN * ROWS;
constexpr int TARGET_BLOCKS = 132 * 16;  // about 16 blocks per SM
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
threshold_kernel(const int32_t* __restrict__ acc,
                 const float* __restrict__ thr,
                 const float* __restrict__ sign, int32_t* __restrict__ out,
                 int M, int N, int L) {
  extern __shared__ float s_thr[];         // [L][BN], then sign [BN]
  float* s_sign = s_thr + (size_t)L * BN;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * BN + lane;
  const int n0 = blockIdx.x * BN;
  // consecutive threads read consecutive thresholds of [N, L]
  for (int i = tid; i < L * BN; i += THREADS) {
    const int c = i / L;
    const int l = i % L;
    s_thr[l * BN + c] = (n0 + c < N) ? thr[(size_t)(n0 + c) * L + l] : 0.f;
  }
  if (tid < BN) s_sign[tid] = (n0 + tid < N) ? sign[n0 + tid] : 0.f;
  __syncthreads();

  const int n = n0 + lane;
  if (n >= N) return;
  const float sg = s_sign[lane];
  for (int m = blockIdx.y * ROWS + threadIdx.y; m < M;
       m += gridDim.y * ROWS) {
    const size_t o = (size_t)m * N + n;
    const float a = __fmul_rn(__int2float_rn(acc[o]), sg);
    int32_t q = 0;
    for (int l = 0; l < L; ++l) q += (a >= s_thr[l * BN + lane]) ? 1 : 0;
    out[o] = q;
  }
}

}  // namespace

// Shared memory bytes a launch with L levels needs (the wrapper keeps it
// under the 48 KB a launch gets without opting in).
extern "C" long long threshold_smem_bytes(int L) {
  return (long long)(L + 1) * BN * (long long)sizeof(float);
}

extern "C" int threshold_launch(const void* acc, const void* thr,
                                const void* sign, void* out, int M, int N,
                                int L, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int gx = (N + BN - 1) / BN;
  const int rows = (M + ROWS - 1) / ROWS;
  const int gy = std::max(1, std::min({rows, (TARGET_BLOCKS + gx - 1) / gx,
                                       MAX_GRID_Y}));
  const size_t smem = (size_t)threshold_smem_bytes(L);
  threshold_kernel<<<dim3(gx, gy), dim3(BN, ROWS), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(thr),
      static_cast<const float*>(sign), static_cast<int32_t*>(out), M, N, L);
  return (int)cudaGetLastError();
}
