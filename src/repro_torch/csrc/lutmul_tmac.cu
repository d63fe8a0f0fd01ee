// T-MAC bitplane multiply on Hopper:
//   acc[m, n] = sum_b coeff_b * sum_k a[m, k] * plane_b[k, n]
//               + const * sum_k a[m, k]
//
// Replaces the Pallas kernels lutmul_tmac_pallas and lutmul_tmac_fused_pallas
// (src/repro/kernels/lutmul/kernel.py:289 and :430).  The TPU version builds
// one-hot operands for an MXU dot, the TPU's way to a table lookup; here the
// lookup is a lookup.  Exact integer sums, bitwise equal to
// kernels/lutmul/ref.py; the fused entry point then writes
// ((float)acc * a_scale[m]) * w_scale[n], rounded with __float2bfloat16_rn.
//
// Layout: a [M, K] int8 signed activation codes; planes [P, K/8, N] uint8
// (bit i of byte j is plane row 8j + i), P <= 4; per-plane coefficients
// (|coeff| <= 8) and the additive const are kernel arguments; a_scale [M]
// and w_scale [N] float32 for the fused epilogue.  K % 8 == 0; M, N and the
// last K tile may be ragged.
//
// g = 2 (a4 activations): per K tile the block builds the partial-sum table
// T[m][kg][c] = sum_i bit_i(c) * a[m, 2kg + i] (4 int8 entries per group,
// one 32-bit word) in shared memory.  Each plane byte holds four 2-bit group
// codes.  A lane keeps the four table words of a byte's groups in registers
// and looks entries up with __byte_perm: one PRMT selects, for one row, the
// entries of two groups for two planes at once, and one __dp4a scales them
// by the two planes' coefficients and adds them.  Table entries are pair
// sums of 4-bit codes, in [-16, 14], so they fit int8.
// g = 1 (a8 activations): the table degenerates to the activation itself.
// A nibble of a plane byte is spread into a 0/1 byte mask (times the plane's
// coefficient) and __dp4a takes four activation bytes against it.
// w1 adds const * sum_k a[m, k] from a per-block row sum.
//
// Bound at decode (M = 8): the weight bytes, P*K*N/8, are what must move
// (116 MB per qwen2-7b layer at P = 4, 0.035 ms at 3.35 TB/s).  g = 2 does
// M*P*K*N/2 table reads; here that is M*P*K*N/8 PRMT plus as many DP4A on
// the integer pipe (64 lanes per clock per SM): about 0.14 ms per qwen2-7b
// layer at P = 4, about four times the byte time, so the kernel is bounded
// by the integer pipe, not by HBM.  What the design does about it: each
// lane takes 4 neighbouring columns with one 32-bit load per plane byte row
// (a warp reads 128 contiguous bytes), the four table words of a byte row
// are one 16-byte shared-memory broadcast reused for 4 columns and P
// planes, and the selectors are built once per column and reused for all
// 8 rows.
//
// Blocks run in no order and nothing carries across them, so K is split over
// grid.z until the grid has about 8 blocks per SM: each split adds its
// partial sums into an int32 workspace with atomicAdd (integer addition:
// order-free, exact), then counts itself in the tile's arrival counter; the
// last block to arrive reads the sums back, re-zeroes them and the counter,
// and writes the output through the epilogue (the scheme of lutmul.cu).  One
// launch per call; the workspace is left zero for the next one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 8;              // activation rows per block
constexpr int CPL = 4;             // columns per lane (one 32-bit load)
constexpr int BN = 32 * CPL;       // columns per block
constexpr int KS = 4;              // warps per block, each a slice of a tile
constexpr int BK = 128;            // k per shared activation tile
constexpr int JT = BK / 8;         // plane byte rows per tile
constexpr int JW = JT / KS;        // byte rows per warp per tile
constexpr int THREADS = 32 * KS;
constexpr int TARGET_BLOCKS = 132 * 8;   // about 8 resident blocks per SM

static_assert(JT * BM == THREADS, "one table entry per thread per tile");
static_assert(JW * KS == JT, "tile must split evenly over warps");

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };

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

// the 4 plane bytes of columns n0..n0+3 (byte c of the word is column n0+c)
__device__ __forceinline__ uint32_t load_cols(const uint8_t* row, int n0,
                                              int N, bool vec) {
  if (vec) {
    return n0 < N ? __ldg(reinterpret_cast<const uint32_t*>(row + n0)) : 0u;
  }
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (n0 + c < N) v |= (uint32_t)__ldg(row + n0 + c) << (8 * c);
  }
  return v;
}

// __byte_perm selectors over the table words of groups (0, 1) and (2, 3)
// of a plane byte b: nibble 0 picks entry c0 of the first word, nibble 1
// entry c1 of the second (input bytes 4..7)
__device__ __forceinline__ uint32_t sel_lo(uint32_t b) {
  return (b & 3u) | ((b & 0xCu) << 2) | 0x40u;
}
__device__ __forceinline__ uint32_t sel_hi(uint32_t b) {
  return ((b >> 4) & 3u) | ((b >> 2) & 0x30u) | 0x40u;
}

// 0/1 byte mask of the 4 bits of a nibble (bit i -> byte i), times the
// plane coefficient as a byte (no carries: each byte is 0 or coeff & 0xFF)
__device__ __forceinline__ uint32_t nibble_mask(uint32_t nib, uint32_t cb) {
  return ((nib * 0x204081u) & 0x01010101u) * cb;
}

// partial sums of k in [blockIdx.z * k_chunk, ... + k_chunk): written with
// the epilogue when gridDim.z is 1, else added into acc_ws (int32 [M, N])
// and written by the tile's last-arriving block (count: [gridDim.y,
// gridDim.x] arrival counters); both zero on entry and on exit
template <int P, int G, int EPI>
__global__ void __launch_bounds__(THREADS)
tmac_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ planes,
            int4 coeffs, int cnst, const float* __restrict__ a_scale,
            const float* __restrict__ w_scale, void* __restrict__ out,
            int32_t* __restrict__ acc_ws, unsigned* __restrict__ count,
            int M, int K, int N, int k_chunk) {
  // g = 2: 4 table words per (byte row, m); g = 1: the 8 activation bytes
  __shared__ __align__(16) uint32_t s_tab[JT * BM * 4];
  __shared__ __align__(16) int32_t s_red[KS][BM][BN];
  __shared__ int32_t s_rowsum[BM];
  __shared__ bool s_last;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int n0 = blockIdx.x * BN + lane * CPL;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int j_end = k_end / 8;
  const int KB = K / 8;
  const bool vec = (N % 4) == 0;

  const int co[4] = {coeffs.x, coeffs.y, coeffs.z, coeffs.w};
  // g = 2: per plane pair (p, q) the dp4a weights [co_p, co_p, co_q, co_q]
  // g = 1: per plane the coefficient as a byte
  constexpr int NPAIR = (P + 1) / 2;
  uint32_t cw[G == 2 ? NPAIR : P];
#pragma unroll
  for (int i = 0; i < (G == 2 ? NPAIR : P); ++i) {
    if (G == 2) {
      const uint32_t bp = (uint32_t)co[2 * i] & 0xFFu;
      const uint32_t bq = 2 * i + 1 < P ? (uint32_t)co[2 * i + 1] & 0xFFu : 0u;
      cw[i] = bp | (bp << 8) | (bq << 16) | (bq << 24);
    } else {
      cw[i] = (uint32_t)co[i] & 0xFFu;
    }
  }
  if (tid < BM) s_rowsum[tid] = 0;

  int32_t acc[BM][CPL];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int j0 = k0 / 8;
    __syncthreads();   // the previous tile is consumed
    {
      // one (byte row, m) entry per thread; 16 threads read 128 contiguous
      // activation bytes of one row
      const int jl = tid % JT;
      const int m = tid / JT;
      const int gm = m0 + m;
      uint2 v = make_uint2(0u, 0u);
      if (gm < M && j0 + jl < j_end) {
        v = __ldg(reinterpret_cast<const uint2*>(a + (size_t)gm * K
                                                 + 8 * (j0 + jl)));
      }
      uint32_t* t = s_tab + (jl * BM + m) * 4;
      if (G == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t word = i < 2 ? v.x : v.y;
          const int a0 = (int8_t)(word >> (16 * (i & 1)));
          const int a1 = (int8_t)(word >> (16 * (i & 1) + 8));
          t[i] = ((uint32_t)(a0 & 0xFF) << 8) | ((uint32_t)(a1 & 0xFF) << 16)
                 | ((uint32_t)((a0 + a1) & 0xFF) << 24);
        }
      } else {
        t[0] = v.x;
        t[1] = v.y;
      }
      if (cnst != 0) {
        const int s = __dp4a((int)v.x, 0x01010101,
                             __dp4a((int)v.y, 0x01010101, 0));
        atomicAdd(&s_rowsum[m], s);
      }
    }
    // this warp's plane bytes of the tile, all loads in flight at once
    uint32_t wb[JW][P];
#pragma unroll
    for (int jj = 0; jj < JW; ++jj) {
      const int j = j0 + jj * KS + warp;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        wb[jj][p] = j < j_end
            ? load_cols(planes + ((size_t)p * KB + j) * N, n0, N, vec) : 0u;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < JW; ++jj) {
      const int jl = jj * KS + warp;
      if (j0 + jl >= j_end) continue;   // uniform across the warp
      if (G == 2) {
        uint32_t s01[CPL][NPAIR], s23[CPL][NPAIR];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
#pragma unroll
          for (int i = 0; i < NPAIR; ++i) {
            const uint32_t bp = (wb[jj][2 * i] >> (8 * c)) & 0xFFu;
            const uint32_t bq =
                2 * i + 1 < P ? (wb[jj][2 * i + 1] >> (8 * c)) & 0xFFu : 0u;
            s01[c][i] = sel_lo(bp) | (sel_lo(bq) << 8);
            s23[c][i] = sel_hi(bp) | (sel_hi(bq) << 8);
          }
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const uint4 t =
              *reinterpret_cast<const uint4*>(s_tab + (jl * BM + m) * 4);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
#pragma unroll
            for (int i = 0; i < NPAIR; ++i) {
              acc[m][c] = __dp4a((int)__byte_perm(t.x, t.y, s01[c][i]),
                                 (int)cw[i], acc[m][c]);
              acc[m][c] = __dp4a((int)__byte_perm(t.z, t.w, s23[c][i]),
                                 (int)cw[i], acc[m][c]);
            }
          }
        }
      } else {
        uint32_t lo[CPL][P], hi[CPL][P];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint32_t b = (wb[jj][p] >> (8 * c)) & 0xFFu;
            lo[c][p] = nibble_mask(b & 0xFu, cw[p]);
            hi[c][p] = nibble_mask(b >> 4, cw[p]);
          }
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const uint2 av =
              *reinterpret_cast<const uint2*>(s_tab + (jl * BM + m) * 4);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              acc[m][c] = __dp4a((int)lo[c][p], (int)av.x, acc[m][c]);
              acc[m][c] = __dp4a((int)hi[c][p], (int)av.y, acc[m][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) {
    *reinterpret_cast<int4*>(&s_red[warp][m][lane * CPL]) =
        make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int c = i % BN;
    const int gm = m0 + m;
    const int gn = blockIdx.x * BN + c;
    if (gm >= M || gn >= N) continue;
    int32_t s = cnst * s_rowsum[m];
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

template <int P, int G, int EPI>
int launch(const int8_t* a, const uint8_t* w, int4 co, int cnst,
           const float* as, const float* ws, void* out, int32_t* work,
           int M, int K, int N, cudaStream_t s) {
  const Geometry g = geometry(M, K, N);
  unsigned* count = reinterpret_cast<unsigned*>(work + (size_t)M * N);
  tmac_kernel<P, G, EPI><<<g.grid, dim3(32, KS), 0, s>>>(
      a, w, co, cnst, as, ws, out, work, count, M, K, N, g.k_chunk);
  return (int)cudaGetLastError();
}

template <int P, int G>
int by_epilogue(int epi, const int8_t* a, const uint8_t* w, int4 co,
                int cnst, const float* as, const float* ws, void* out,
                int32_t* work, int M, int K, int N, cudaStream_t s) {
  switch (epi) {
    case kInt32:
      return launch<P, G, kInt32>(a, w, co, cnst, as, ws, out, work, M, K,
                                  N, s);
    case kBf16:
      return launch<P, G, kBf16>(a, w, co, cnst, as, ws, out, work, M, K, N,
                                 s);
    case kF32:
      return launch<P, G, kF32>(a, w, co, cnst, as, ws, out, work, M, K, N,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int G>
int by_planes(int P, int epi, const int8_t* a, const uint8_t* w, int4 co,
              int cnst, const float* as, const float* ws, void* out,
              int32_t* work, int M, int K, int N, cudaStream_t s) {
  switch (P) {
    case 1:
      return by_epilogue<1, G>(epi, a, w, co, cnst, as, ws, out, work, M, K,
                               N, s);
    case 2:
      return by_epilogue<2, G>(epi, a, w, co, cnst, as, ws, out, work, M, K,
                               N, s);
    case 3:
      return by_epilogue<3, G>(epi, a, w, co, cnst, as, ws, out, work, M, K,
                               N, s);
    case 4:
      return by_epilogue<4, G>(epi, a, w, co, cnst, as, ws, out, work, M, K,
                               N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// int32 words of the workspace a call at (M, N) needs: the [M, N] split
// sums, then one arrival counter per output tile.  It must be zero before
// the first call; every call leaves it zero.
extern "C" long long lutmul_tmac_workspace_words(int M, int N) {
  return (long long)M * N
         + (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// a: int8 [M, K]; planes: uint8 [P, K/8, N]; coefficients c0..c3 (the
// first P used), const; g in {1, 2}; a 16-byte aligned a and planes.
extern "C" int lutmul_tmac_launch(const void* a, const void* planes,
                                  const void* a_scale, const void* w_scale,
                                  void* out, void* workspace, int M, int K,
                                  int N, int P, int g, int c0, int c1, int c2,
                                  int c3, int cnst, int epilogue,
                                  void* stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const uint8_t* w8 = static_cast<const uint8_t*>(planes);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  int32_t* work = static_cast<int32_t*>(workspace);
  const int4 co = make_int4(c0, c1, c2, c3);
  if (g == 1) {
    return by_planes<1>(P, epilogue, a8, w8, co, cnst, as, ws, out, work, M,
                        K, N, s);
  }
  if (g == 2) {
    return by_planes<2>(P, epilogue, a8, w8, co, cnst, as, ws, out, work, M,
                        K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
