// int8 x int8 -> int32 matmul on Hopper, with an optional fused dequant
// epilogue.
//
// Replaces the Pallas kernels int_matmul_pallas and int_matmul_fused_pallas
// (src/repro/kernels/lutmul/kernel.py:332 and :483).  On the main path it
// serves the w8a8 lm_head: a [M, K] int8 activation codes, w [K, N] int8
// weight codes, a_scale [M] / w_scale [N] float32.
//
// Bound: at decode (M = 8) the K*N weight bytes dominate — 545 MB for the
// qwen2-7b head, 0.16 ms at 3.35 TB/s; the M*K*N multiply-adds are far
// below the int8 peak.  What the design does about it: each lane owns four
// adjacent columns and reads one 32-bit word per weight row, so a warp
// reads 512 contiguous bytes of a row (fully coalesced); four rows are
// transposed in registers with byte permutes into k-quads and reduced with
// __dp4a against the activation k-quads, which sit in shared memory as a
// [k/4][m] tile of 32-bit words (two 16-byte broadcast loads per k-quad).
// Each block loops over all of K itself (Hopper blocks run in no order);
// its KS warps take interleaved k-quads of every tile and a shared-memory
// reduction adds the slices (integer sums: order-free, exact).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;            // activation rows per block
constexpr int CPT = 4;           // columns per lane
constexpr int BN = 32 * CPT;     // columns per block
constexpr int KS = 8;            // warps per block
constexpr int BK = 256;          // k per shared activation tile
constexpr int KQ = BK / 4;       // k-quads per tile
constexpr int KQW = KQ / KS;     // k-quads per warp per tile
constexpr int THREADS = 32 * KS;

static_assert(BM == 8, "the two 16-byte activation loads assume 8 rows");
static_assert(KQW * KS == KQ, "tile must split evenly over warps");

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };

// four weight bytes (columns n..n+3) of row k + r; zero past K or N
__device__ __forceinline__ uint32_t load_row(const int8_t* __restrict__ w,
                                             int k, int n, int K, int N,
                                             bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = w + (size_t)k * N + n;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (n + c < N) v |= (uint32_t)(uint8_t)p[c] << (8 * c);
  }
  return v;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
int_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ w_scale, void* __restrict__ out,
                  int M, int K, int N) {
  __shared__ __align__(16) uint32_t s_a[KQ * BM];   // [k/4][m] k-quads
  __shared__ int32_t s_red[KS][BM][BN];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int n = blockIdx.x * BN + lane * CPT;
  const int m0 = blockIdx.y * BM;
  // whole-word loads need the four columns in range and 4-byte alignment
  const bool vec = (N % CPT == 0) && (n + CPT <= N)
                   && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const bool col_ok = n < N;

  int32_t acc[BM][CPT];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < KQ * BM; i += THREADS) {
      const int m = i / KQ;
      const int q = i % KQ;
      const int gm = m0 + m;
      uint32_t v = 0u;
      if (gm < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + 4 * q + j;
          if (gk < K) {
            v |= (uint32_t)(uint8_t)a[(size_t)gm * K + gk] << (8 * j);
          }
        }
      }
      s_a[q * BM + m] = v;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 2
      for (int j = 0; j < KQW; ++j) {
        const int q = j * KS + warp;
        const int k = k0 + 4 * q;
        if (k >= K) break;
        const uint32_t r0 = load_row(w, k, n, K, N, vec);
        const uint32_t r1 = load_row(w, k + 1, n, K, N, vec);
        const uint32_t r2 = load_row(w, k + 2, n, K, N, vec);
        const uint32_t r3 = load_row(w, k + 3, n, K, N, vec);
        // transpose 4 rows x 4 columns of bytes into one k-quad per column
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
        const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
        const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
        int wq[CPT];
        wq[0] = (int)__byte_perm(lo01, lo23, 0x5410);
        wq[1] = (int)__byte_perm(lo01, lo23, 0x7632);
        wq[2] = (int)__byte_perm(hi01, hi23, 0x5410);
        wq[3] = (int)__byte_perm(hi01, hi23, 0x7632);
        const uint4 a_lo = *reinterpret_cast<const uint4*>(s_a + q * BM);
        const uint4 a_hi = *reinterpret_cast<const uint4*>(s_a + q * BM + 4);
        const int av[BM] = {(int)a_lo.x, (int)a_lo.y, (int)a_lo.z,
                            (int)a_lo.w, (int)a_hi.x, (int)a_hi.y,
                            (int)a_hi.z, (int)a_hi.w};
#pragma unroll
        for (int m = 0; m < BM; ++m)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            acc[m][c] = __dp4a(av[m], wq[c], acc[m][c]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s_red[warp][m][lane * CPT + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int c = i % BN;
    const int gm = m0 + m;
    const int gn = blockIdx.x * BN + c;
    if (gm >= M || gn >= N) continue;
    int32_t s = 0;
#pragma unroll
    for (int q = 0; q < KS; ++q) s += s_red[q][m][c];
    const size_t o = (size_t)gm * N + gn;
    if (EPI == kInt32) {
      static_cast<int32_t*>(out)[o] = s;
    } else {
      const float y = ((float)s * a_scale[gm]) * w_scale[gn];
      if (EPI == kBf16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      } else {
        static_cast<float*>(out)[o] = y;
      }
    }
  }
}

}  // namespace

extern "C" int int_matmul_launch(const void* a, const void* w,
                                 const void* a_scale, const void* w_scale,
                                 void* out, int M, int K, int N, int epilogue,
                                 void* stream) {
  const dim3 block(32, KS);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  switch (epilogue) {
    case kInt32:
      int_matmul_kernel<kInt32><<<grid, block, 0, s>>>(a8, w8, as, ws, out,
                                                       M, K, N);
      break;
    case kBf16:
      int_matmul_kernel<kBf16><<<grid, block, 0, s>>>(a8, w8, as, ws, out,
                                                      M, K, N);
      break;
    case kF32:
      int_matmul_kernel<kF32><<<grid, block, 0, s>>>(a8, w8, as, ws, out,
                                                     M, K, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
