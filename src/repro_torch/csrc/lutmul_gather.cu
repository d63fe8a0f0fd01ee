// Serial LUT gather on Hopper: acc[m, n] = sum_k T[(w[k, n] << 4) | a[m, k]].
//
// Replaces lutmul_pallas(impl="gather") (src/repro/kernels/lutmul/kernel.py
// :178, body _lutmul_gather_body :153): the retained A/B baseline, one
// gather per product from the flat 256-entry table, walked serially over k.
// It stays that simple on purpose; csrc/lutmul.cu is the kernel that
// serves.  The sums are int32 and exact, so it equals lutmul.cu's int32
// entry bit for bit.
//
// Layout: a [M, K] uint8 4-bit codes, w [K/2, N] uint8 nibble pairs (byte
// k2 holds w[2*k2] in its low nibble), table [16, 16] int32 with row =
// weight code (flat index (w << 4) | a, the reference's), out [M, N] int32.
//
// Bound: the bytes are M*K + K*N/2 + 4*M*N, but a thread walks all of K
// alone, one byte load and one dependent shared-memory gather per product:
// the time is set by that serial chain (K steps per thread) and by the
// M*K*N gathers at 32 shared-memory words per clock per SM, not by device
// memory.  The design: the table lives in shared memory; each thread owns
// one column (lanes on neighbouring columns, so a warp's weight bytes are
// one 32-byte sector) and RPT rows (a warp's activation byte is one
// broadcast); there is no K split and no workspace.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;               // columns per block, one per lane
constexpr int WARPS = 8;
constexpr int RPT = 4;               // rows per thread
constexpr int BM = WARPS * RPT;      // rows per block
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(BN * WARPS)
lutmul_gather_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ w,
                     const int32_t* __restrict__ table,
                     int32_t* __restrict__ out, int M, int K, int N) {
  __shared__ int32_t s_t[256];
  const int tid = threadIdx.y * BN + threadIdx.x;
  for (int i = tid; i < 256; i += BN * WARPS) s_t[i] = table[i];
  __syncthreads();

  const int n = blockIdx.x * BN + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * BM + threadIdx.y;   // rows m0 + r * WARPS
  int32_t acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0;
  for (int k2 = 0; k2 < K / 2; ++k2) {
    const uint32_t wb = w[(size_t)k2 * N + n];
    const uint32_t lo = (wb & 0xFu) << 4;
    const uint32_t hi = (wb >> 4) << 4;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int m = m0 + r * WARPS;
      if (m < M) {
        const uint8_t* ar = a + (size_t)m * K + 2 * k2;
        acc[r] += s_t[lo | (ar[0] & 0xFu)] + s_t[hi | (ar[1] & 0xFu)];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + r * WARPS;
    if (m < M) out[(size_t)m * N + n] = acc[r];
  }
}

}  // namespace

extern "C" int lutmul_gather_launch(const void* a, const void* w,
                                    const void* table, void* out, int M,
                                    int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int gy = (M + BM - 1) / BM;   // the wrapper keeps it in range
  if (gy > MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  lutmul_gather_kernel<<<dim3((N + BN - 1) / BN, gy), dim3(BN, WARPS), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), M, K,
      N);
  return (int)cudaGetLastError();
}
