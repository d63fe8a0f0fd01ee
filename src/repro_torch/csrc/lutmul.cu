// LUT multiply on Hopper: acc[m, n] = sum_k T[w[k, n]][a[m, k]].
//
// Replaces the Pallas kernels lutmul_pallas(impl="onehot") and
// lutmul_fused_pallas (src/repro/kernels/lutmul/kernel.py:178 and :380).
// The TPU version re-expresses the lookup as two one-hot int8 MXU dots;
// here every product is a real lookup into the [16, 16] product table held
// in shared memory, summed in int32 (the paper's semantics).  The table is
// a kernel argument, so activation signedness lives in the table alone.
//
// Layout: a [M, K] uint8 4-bit codes, w [K/2, N] uint8 nibble pairs (byte
// k2 holds w[2*k2] in its low nibble), table [16, 16] int32 (row = weight
// code), a_scale [M] and w_scale [N] float32 for the fused epilogue.
//
// Bound: at decode (M = 8 slots) the weight bytes are read once, K*N/2
// bytes over 3.35 TB/s; but the lookups, M*K*N of them, are the larger
// cost on this card (32 shared-memory words per clock per SM), so the
// kernel is bounded by the table reads rather than by HBM.  What the design
// does about it: lanes map to columns, so the packed weight bytes of a warp
// are one coalesced 32-byte sector per k2 row and each byte is unpacked
// once for all BM rows; the table is stored column-transposed
// (s_t[a * 16 + w]) so the 32 lanes of a warp, which share the activation
// code and differ in the weight code, read 16 distinct banks without
// conflict; activation codes are kept pre-shifted (a << 4) in shared memory
// as a [k][m] tile so one 16-byte broadcast load feeds a k2 step; a warp
// issues all its weight loads of a tile before its first lookup.
//
// Hopper blocks run in no order and nothing carries across them, so each
// block loops over its own range of K.  At decode a column tile alone gives
// too few blocks to fill 132 SMs (N = 512 is 16 tiles), so K is split over
// grid.z: each split adds its partial sums into an int32 workspace with
// atomicAdd (integer addition: order-free, exact), then counts itself in
// the tile's arrival counter; the last block to arrive reads the sums back,
// re-zeroes them and the counter, and writes the output through the
// epilogue.  One launch per call, and the workspace is left zeroed for the
// next one, so the caller allocates it once and never clears it.  Within a
// block the KS warps take interleaved k2 rows of every tile and a
// shared-memory reduction adds them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 8;          // activation rows per block (the slot count)
constexpr int BN = 32;         // columns per block, one per lane
constexpr int KS = 8;          // warps per block, each a slice of every tile
constexpr int BK = 256;        // k per shared activation tile (split unit)
constexpr int K2W = BK / 2 / KS;   // packed rows per warp per tile
constexpr int THREADS = BN * KS;
constexpr int TARGET_BLOCKS = 132 * 8;   // about 8 resident blocks per SM

static_assert(BM == 8, "the 16-byte activation load assumes 8 rows");
static_assert(K2W * KS * 2 == BK, "tile must split evenly over warps");

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };

__device__ __forceinline__ int32_t row_lookup(const int32_t* t_col,
                                              uint32_t word, int byte) {
  return t_col[(word >> (8 * byte)) & 0xFFu];
}

template <int EPI>
__device__ __forceinline__ void store(void* out, size_t o, int32_t s,
                                      float a_s, float w_s) {
  if (EPI == kInt32) {
    static_cast<int32_t*>(out)[o] = s;
  } else {
    const float y = ((float)s * a_s) * w_s;
    if (EPI == kBf16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    } else {
      static_cast<float*>(out)[o] = y;
    }
  }
}

// partial sums of k in [blockIdx.z * k_chunk, ... + k_chunk): written with
// the epilogue when gridDim.z is 1, else added into acc_ws (int32 [M, N])
// and written by the tile's last-arriving block (count: [gridDim.y,
// gridDim.x] arrival counters); both zero on entry and on exit
template <int EPI>
__global__ void __launch_bounds__(THREADS)
lutmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
              const int32_t* __restrict__ table,
              const float* __restrict__ a_scale,
              const float* __restrict__ w_scale, void* __restrict__ out,
              int32_t* __restrict__ acc_ws, unsigned* __restrict__ count,
              int M, int K, int N, int k_chunk) {
  __shared__ int32_t s_t[256];                     // [a_code][w_code]
  __shared__ __align__(16) uint8_t s_a[BK * BM];   // [k][m], a << 4
  __shared__ int32_t s_red[KS][BM][BN];
  __shared__ bool s_last;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * BN + lane;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = n < N;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  for (int i = tid; i < 256; i += THREADS) {
    s_t[i] = table[(i & 15) * 16 + (i >> 4)];
  }

  int32_t acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int m = i / BK;            // consecutive threads: consecutive k
      const int k = i % BK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      uint8_t v = 0;
      if (gm < M && gk < k_end) {
        v = (uint8_t)((a[(size_t)gm * K + gk] & 0xF) << 4);
      }
      s_a[k * BM + m] = v;
    }
    // this warp's weight bytes of the tile, all loads in flight at once
    uint32_t wb[K2W];
#pragma unroll
    for (int j = 0; j < K2W; ++j) {
      const int k2 = k0 / 2 + j * KS + warp;
      wb[j] = (col_ok && 2 * k2 < k_end) ? w[(size_t)k2 * N + n] : 0u;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int j = 0; j < K2W; ++j) {
        const int t2 = j * KS + warp;          // packed row within the tile
        if (2 * (k0 / 2 + t2) < k_end) {
          const int32_t* t_lo = s_t + (wb[j] & 0xFu);
          const int32_t* t_hi = s_t + (wb[j] >> 4);
          // rows 0-3 / 4-7 of k = 2*t2 (x, y) and of k = 2*t2 + 1 (z, w)
          const uint4 av = *reinterpret_cast<const uint4*>(s_a + 2 * t2 * BM);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[m] += row_lookup(t_lo, av.x, m) + row_lookup(t_hi, av.z, m);
            acc[m + 4] += row_lookup(t_lo, av.y, m)
                          + row_lookup(t_hi, av.w, m);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) s_red[warp][m][lane] = acc[m];
  __syncthreads();
  const bool split = gridDim.z > 1;
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
    if (split) {
      atomicAdd(acc_ws + o, s);
    } else {
      store<EPI>(out, o, s, EPI == kInt32 ? 0.f : a_scale[gm],
                 EPI == kInt32 ? 0.f : w_scale[gn]);
    }
  }
  if (!split) return;

  // this block's sums land before its arrival is counted
  __threadfence();
  __syncthreads();
  const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(count + tile, 1u) == gridDim.z - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();   // every other split's sums are visible past here
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int gm = m0 + i / BN;
    const int gn = blockIdx.x * BN + i % BN;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    const int32_t s = atomicExch(acc_ws + o, 0);   // read and re-zero
    store<EPI>(out, o, s, EPI == kInt32 ? 0.f : a_scale[gm],
               EPI == kInt32 ? 0.f : w_scale[gn]);
  }
  if (tid == 0) count[tile] = 0u;
}

struct Geometry {
  dim3 grid;
  int k_chunk;
};

// split K (in whole tiles) until the grid has about TARGET_BLOCKS blocks
Geometry geometry(int M, int K, int N) {
  const int gx = (N + BN - 1) / BN;
  const int gy = (M + BM - 1) / BM;
  const int tiles = (K + BK - 1) / BK;
  if (tiles <= 1) return {dim3(gx, gy, 1), K > 0 ? K : 1};
  int split = (TARGET_BLOCKS + gx * gy - 1) / (gx * gy);
  split = std::max(1, std::min(split, tiles));
  const int k_chunk = ((tiles + split - 1) / split) * BK;
  return {dim3(gx, gy, (K + k_chunk - 1) / k_chunk), k_chunk};
}

template <int EPI>
int launch(const uint8_t* a, const uint8_t* w, const int32_t* t,
           const float* as, const float* ws, void* out, int32_t* work,
           int M, int K, int N, cudaStream_t s) {
  const Geometry g = geometry(M, K, N);
  if (g.grid.y > 65535u) return (int)cudaErrorInvalidValue;  // M > 524,280
  unsigned* count = reinterpret_cast<unsigned*>(work + (size_t)M * N);
  lutmul_kernel<EPI><<<g.grid, dim3(BN, KS), 0, s>>>(
      a, w, t, as, ws, out, work, count, M, K, N, g.k_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 words of the workspace a call at (M, N) needs: the [M, N] split
// sums, then one arrival counter per output tile.  It must be zero before
// the first call; every call leaves it zero.
extern "C" long long lutmul_workspace_words(int M, int N) {
  return (long long)M * N
         + (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

extern "C" int lutmul_launch(const void* a, const void* w, const void* table,
                             const void* a_scale, const void* w_scale,
                             void* out, void* workspace, int M, int K, int N,
                             int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const uint8_t* w8 = static_cast<const uint8_t*>(w);
  const int32_t* t = static_cast<const int32_t*>(table);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  int32_t* work = static_cast<int32_t*>(workspace);
  switch (epilogue) {
    case kInt32:
      return launch<kInt32>(a8, w8, t, as, ws, out, work, M, K, N, s);
    case kBf16:
      return launch<kBf16>(a8, w8, t, as, ws, out, work, M, K, N, s);
    case kF32:
      return launch<kF32>(a8, w8, t, as, ws, out, work, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
