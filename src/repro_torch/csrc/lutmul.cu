// LUT multiply on Hopper's int8 tensor cores:
//   acc[m, n] = sum_k T[w[k, n], a[m, k]]
//             = sum_k sum_b bit_b(a[m, k]) * T[w[k, n], 2^b]      (b = 0..3)
//
// Replaces the Pallas kernels lutmul_pallas(impl="onehot") and
// lutmul_fused_pallas (src/repro/kernels/lutmul/kernel.py:178 and :380),
// as the TPU kernel's _onehot_contract (:98) computes them, in two stages.
// Selection: each weight code looks up its word in a 16-word table,
// word[w] = int8x4 (T[w, 1], T[w, 2], T[w, 4], T[w, 8]); T[w, 8] carries
// the sign of the activation's top bit, so signedness lives in the table
// alone (core/lut.py contraction_words).  Contraction: the 0/1 bitplanes of
// the activation codes against those bytes, over k' = (k, b), with
// mma.sync.m16n8k32 s8 x s8 -> s32 (exact integer sums).
//
// Layout: a [M, K] uint8 4-bit codes, w [K/2, N] uint8 nibble pairs (byte
// k2 holds w[2*k2] in its low nibble), words [16] int32, a_scale [M] and
// w_scale [N] float32 for the fused epilogue.
//
// Bound on the H100: bytes.  The bitplane form does 4x the MACs of an int8
// product, which the tensor cores still finish far under the time the
// bytes take: at decode (M = 8) the K*N/2 weight bytes, at the CNN stages
// the M*N*4 output bytes.  Next to them come the lookups, one shared-memory
// load per weight nibble: at decode about as many SM clocks as the weight
// bytes take.  What the design does about it:
//  * weight columns on the instruction's 16-row side and activation rows on
//    its 8-column side (acc^T = TW^T . bits^T), so 8 decode rows fill the
//    instruction and each lookup serves all the rows of a warp's tile;
//  * each lane owns 4 adjacent columns (n = 32q + 4g + t for lane group g)
//    and the k2 rows 4*tig + s of each 32-deep chunk (tig = lane % 4, step
//    s = 0..3): one 4-byte load of the packed weights gives both nibbles
//    of 4 columns, i.e. the A fragments of two m16 tiles for one step
//    after 8 lookups, and one 8-byte load of a row's codes gives its B
//    fragments for all 4 steps ((x * 0x00204081) & 0x01010101 turns a
//    nibble into its 4 bitplane bytes); the k order inside a chunk is the
//    lanes', the same for both operands;
//  * a lookup is one PRMT and one shared load: the 16 words sit 256-byte
//    aligned on 16 banks (no conflict), and the PRMT writes 4x the nibble
//    into the low byte of the table's address;
//  * the accumulator fragment holds, per row, the lane's 4 adjacent
//    columns: one 16-byte store (8 for bf16) per row, 128 contiguous bytes
//    per warp and row;
//  * the weights go straight from device memory to registers (they are
//    read once), the next chunk's loads issued before this one's math.
//
// Tiles by M, chosen by timing variants at the served shapes: up to 16 rows
// (decode) a block is 8 warps over one 64-column, 8-row tile (two row tiles
// for 9-16 rows), each warp a share of the K chunks, summed in shared
// memory; above that (the CNN stages, M = 1,568 - 401,408 at K = 16 - 960)
// a block is 4 warps of 16 rows x 32 columns.  Row tiles ride grid.x, so
// the rows are not capped at 65,535 tiles.
//
// Hopper blocks run in no order and nothing carries across them.  When the
// row and column tiles leave the card idle, K is split over grid.z (as far
// as the blocks still fit in one wave: a second, partial wave costs more
// than the split saves): each
// split adds its partial sums into an int32 workspace with atomicAdd
// (integer addition: order-free, exact), then counts itself in the tile's
// arrival counter; the last block to arrive reads the sums back, re-zeroes
// them and the counter, and writes the output through the epilogue.  One
// launch per call, and the workspace is left zeroed for the next one, so
// the caller allocates it once and never clears it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };
enum Flags { kWVec = 1, kAVec = 2, kOVec = 4 };

constexpr int KC = 32;   // k per chunk: 4 mma steps of 8 k (32 deep in k')
constexpr int kDecodeRows = 16;   // the decode tile up to here, else tall

// NG 32-column groups (2 m16 tiles each) and TM 8-row tiles per warp; WM
// warps along rows, WK along K; MINB blocks per SM; at most TARGET blocks
// once K is split.
template <int NG_, int TM_, int WM_, int WK_, int MINB_, int TARGET_>
struct Tile {
  static constexpr int NG = NG_, TM = TM_, WM = WM_, WK = WK_;
  static constexpr int MINB = MINB_, TARGET = TARGET_;
  static constexpr int BN = 32 * NG;
  static constexpr int BM = 8 * TM * WM;
  static constexpr int THREADS = 32 * WM * WK;
  static constexpr int RED = WK > 1 ? WK * BM * BN : 4;
};

using Decode = Tile<2, 1, 1, 8, 4, 132 * 4>;   // M <= kDecodeRows
using Tall = Tile<1, 2, 4, 1, 8, 132 * 2>;      // M > kDecodeRows

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the selection word at byte offset (4 * code) = byte i of offs; the table
// is 256-byte aligned in shared memory, so its address is s_base with the
// low byte replaced (one PRMT)
__device__ __forceinline__ uint32_t lookup(uint32_t s_base, uint32_t offs,
                                          int i) {
  const uint32_t addr = __byte_perm(offs, s_base, 0x7650 | i);
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// the 4 bitplane bytes (bit b in byte b) of the code in byte i of x
__device__ __forceinline__ uint32_t planes(uint32_t x, int i) {
  return (((x >> (8 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// 4 output values of row m, columns n .. n+3, through the epilogue
template <int EPI>
__device__ __forceinline__ void store4(void* out, const float* a_scale,
                                       const float* w_scale, int m, int n,
                                       int N, const int32_t (&v)[4],
                                       bool vec) {
  const size_t o = (size_t)m * N + n;
  if (EPI == kInt32) {
    int32_t* p = static_cast<int32_t*>(out) + o;
    if (vec) {
      *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (n + t < N) p[t] = v[t];
      }
    }
    return;
  }
  const float a_s = a_scale[m];
  float y[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    y[t] = n + t < N ? ((float)v[t] * a_s) * w_scale[n + t] : 0.f;
  }
  if (EPI == kBf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
    if (vec) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (n + t < N) p[t] = __float2bfloat16_rn(y[t]);
      }
    }
  } else {
    float* p = static_cast<float*>(out) + o;
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (n + t < N) p[t] = y[t];
      }
    }
  }
}

// row m, columns n .. n+3: into the split workspace or through the epilogue
template <int EPI>
__device__ __forceinline__ void put4(void* out, int32_t* acc_ws,
                                     const float* a_scale,
                                     const float* w_scale, int m, int n,
                                     int M, int N, const int32_t (&v)[4],
                                     bool split, bool vec) {
  if (m >= M || n >= N) return;
  if (split) {
    const size_t o = (size_t)m * N + n;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (n + t < N) atomicAdd(acc_ws + o + t, v[t]);
    }
  } else {
    store4<EPI>(out, a_scale, w_scale, m, n, N, v, vec);
  }
}

// partial sums of k in [blockIdx.z * k_chunk, ... + k_chunk): written with
// the epilogue when gridDim.z is 1, else added into acc_ws (int32 [M, N])
// and written by the tile's last-arriving block (count: one arrival counter
// per (blockIdx.y, blockIdx.x)); both zero on entry and on exit
template <class T, int EPI>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
lutmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
              const uint32_t* __restrict__ words,
              const float* __restrict__ a_scale,
              const float* __restrict__ w_scale, void* __restrict__ out,
              int32_t* __restrict__ acc_ws, unsigned* __restrict__ count,
              int M, int K, int N, int k_chunk, int flags) {
  __shared__ __align__(256) uint32_t s_word[16];
  __shared__ __align__(16) int32_t s_red[T::RED];   // [WK][BM][BN]
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp % T::WM;
  const int wk = warp / T::WM;
  const int bm0 = blockIdx.x * T::BM;           // the block's first row
  const int m0 = bm0 + wm * 8 * T::TM;          // the warp's first row
  const int n0 = blockIdx.y * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int k2_end = k_end >> 1;                // K and k_chunk are even
  const bool wvec = flags & kWVec;
  const bool avec = flags & kAVec;

  if (tid < 16) s_word[tid] = words[tid];
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_word));
  if (s_base & 0xFFu) __trap();   // lookup() needs the 256-byte alignment
  __syncthreads();

  int32_t acc[T::TM][2 * T::NG][4];
#pragma unroll
  for (int j = 0; j < T::TM; ++j)
#pragma unroll
    for (int i = 0; i < 2 * T::NG; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][i][r] = 0;

  // chunk at kc: wv[q][s] = w[kc/2 + 4*tig + s, n0 + 32q + 4g .. +3],
  // av[j] = a[m0 + 8j + g, kc + 8*tig .. +7]; zero outside the matrices
  auto load = [&](int kc, uint32_t (&wv)[T::NG][4], uint2 (&av)[T::TM]) {
#pragma unroll
    for (int q = 0; q < T::NG; ++q) {
      const int n = n0 + 32 * q + 4 * g;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k2 = (kc >> 1) + 4 * tig + s;
        uint32_t v = 0;
        if (k2 < k2_end && n < N) {
          const uint8_t* p = w + (size_t)k2 * N + n;
          if (wvec) {
            v = *reinterpret_cast<const uint32_t*>(p);
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (n + t < N) v |= (uint32_t)p[t] << (8 * t);
            }
          }
        }
        wv[q][s] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < T::TM; ++j) {
      const int m = m0 + 8 * j + g;
      const int k = kc + 8 * tig;
      uint2 x = make_uint2(0u, 0u);
      if (m < M && k < k_end) {
        const uint8_t* p = a + (size_t)m * K + k;
        if (avec) {
          x = *reinterpret_cast<const uint2*>(p);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t b = k + i < k_end ? (uint32_t)p[i] : 0u;
            if (i < 4) {
              x.x |= b << (8 * i);
            } else {
              x.y |= b << (8 * (i - 4));
            }
          }
        }
      }
      av[j] = x;
    }
  };

  // uniform per warp: row tiles and column groups past the matrix idle
  bool row_ok[T::TM];
#pragma unroll
  for (int j = 0; j < T::TM; ++j) row_ok[j] = m0 + 8 * j < M;
  bool col_ok[T::NG];
#pragma unroll
  for (int q = 0; q < T::NG; ++q) col_ok[q] = n0 + 32 * q < N;

  // one chunk on the tensor cores: 4 steps of k32 (8 k, 4 bitplanes each)
  auto contract = [&](const uint32_t (&wv)[T::NG][4],
                      const uint2 (&av)[T::TM]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t b[T::TM][2];
#pragma unroll
      for (int j = 0; j < T::TM; ++j) {
        if (!row_ok[j]) continue;
        const uint32_t x = s < 2 ? av[j].x : av[j].y;
        b[j][0] = planes(x, 2 * (s & 1));
        b[j][1] = planes(x, 2 * (s & 1) + 1);
      }
#pragma unroll
      for (int q = 0; q < T::NG; ++q) {
        if (!col_ok[q]) continue;
        // byte t: 4x the low / high nibble (k slot tig / tig+4) of column
        // 4g + t
        const uint32_t lo = (wv[q][s] << 2) & 0x3C3C3C3Cu;
        const uint32_t hi = (wv[q][s] >> 2) & 0x3C3C3C3Cu;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // tile 2q+h: rows g / g+8 are columns 4g + 2h / 4g + 2h + 1
          const uint32_t a0 = lookup(s_base, lo, 2 * h);
          const uint32_t a1 = lookup(s_base, lo, 2 * h + 1);
          const uint32_t a2 = lookup(s_base, hi, 2 * h);
          const uint32_t a3 = lookup(s_base, hi, 2 * h + 1);
#pragma unroll
          for (int j = 0; j < T::TM; ++j) {
            if (row_ok[j]) {
              mma_s8(acc[j][2 * q + h], a0, a1, a2, a3, b[j][0], b[j][1]);
            }
          }
        }
      }
    }
  };

  // a ring of D chunks in registers: the warp's chunks are wk, wk + WK,
  // ...; each slot's next load is issued as soon as it is contracted.
  // Deeper rings spill at the decode tile's 64 registers and ran slower.
  constexpr int D = 2;
  const int step = T::WK * KC;
  uint32_t wv[D][T::NG][4];
  uint2 av[D][T::TM];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    load(k_begin + wk * KC + d * step, wv[d], av[d]);
  }
  for (int kc = k_begin + wk * KC; kc < k_end; kc += D * step) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (kc + d * step < k_end) {
        contract(wv[d], av[d]);
        load(kc + (d + D) * step, wv[d], av[d]);
      }
    }
  }

  // lane (g, tig) holds, for rows 8j + 2*tig + r, columns 32q + 4g .. +3:
  // d[r] and d[2 + r] of tiles 2q and 2q+1
  const bool split = gridDim.z > 1;
  const bool ovec = flags & kOVec;
  if constexpr (T::WK == 1) {
#pragma unroll
    for (int j = 0; j < T::TM; ++j)
#pragma unroll
      for (int q = 0; q < T::NG; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int32_t v[4] = {acc[j][2 * q][r], acc[j][2 * q][2 + r],
                                acc[j][2 * q + 1][r],
                                acc[j][2 * q + 1][2 + r]};
          put4<EPI>(out, acc_ws, a_scale, w_scale, m0 + 8 * j + 2 * tig + r,
                    n0 + 32 * q + 4 * g, M, N, v, split, ovec);
        }
  } else {
#pragma unroll
    for (int j = 0; j < T::TM; ++j)
#pragma unroll
      for (int q = 0; q < T::NG; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ml = wm * 8 * T::TM + 8 * j + 2 * tig + r;
          const int nl = 32 * q + 4 * g;
          *reinterpret_cast<int4*>(s_red + (wk * T::BM + ml) * T::BN + nl) =
              make_int4(acc[j][2 * q][r], acc[j][2 * q][2 + r],
                        acc[j][2 * q + 1][r], acc[j][2 * q + 1][2 + r]);
        }
    __syncthreads();
    for (int i = tid; i < T::BM * T::BN / 4; i += T::THREADS) {
      const int ml = i / (T::BN / 4);
      const int nl = 4 * (i % (T::BN / 4));
      int32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int p = 0; p < T::WK; ++p) {
        const int4 x = *reinterpret_cast<const int4*>(
            s_red + (p * T::BM + ml) * T::BN + nl);
        v[0] += x.x;
        v[1] += x.y;
        v[2] += x.z;
        v[3] += x.w;
      }
      put4<EPI>(out, acc_ws, a_scale, w_scale, bm0 + ml, n0 + nl, M, N, v,
                split, ovec);
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
  for (int i = tid; i < T::BM * T::BN / 4; i += T::THREADS) {
    const int m = bm0 + i / (T::BN / 4);
    const int n = n0 + 4 * (i % (T::BN / 4));
    if (m >= M || n >= N) continue;
    const size_t o = (size_t)m * N + n;
    int32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (n + t < N) v[t] = atomicExch(acc_ws + o + t, 0);   // read, re-zero
    }
    store4<EPI>(out, a_scale, w_scale, m, n, N, v, ovec);
  }
  if (tid == 0) count[tile] = 0u;
}

struct Geometry {
  long long gx;   // row tiles
  long long gy;   // column tiles
  int gz;         // K splits
  int k_chunk;
};

// split K (in whole chunks, at least one per warp) while the grid stays
// within TARGET blocks
template <class T>
Geometry geometry(int M, int K, int N) {
  const long long gx = (M + T::BM - 1) / T::BM;
  const long long gy = (N + T::BN - 1) / T::BN;
  const int chunks = (K + KC - 1) / KC;
  const long long tiles = std::max(1LL, gx * gy);
  const long long split = std::max(
      1LL, std::min(T::TARGET / tiles, (long long)(chunks / T::WK)));
  const int per = (int)((chunks + split - 1) / split);
  const int k_chunk = std::max(1, per) * KC;
  const int gz = std::max(1, (K + k_chunk - 1) / k_chunk);
  return {gx, gy, gz, k_chunk};
}

template <class T, int EPI>
int launch(const uint8_t* a, const uint8_t* w, const uint32_t* words,
           const float* as, const float* ws, void* out, int32_t* work,
           int M, int K, int N, cudaStream_t s) {
  const Geometry g = geometry<T>(M, K, N);
  if (g.gx > 0x7FFFFFFFLL || g.gy > 65535) return (int)cudaErrorInvalidValue;
  const int esize = EPI == kBf16 ? 2 : 4;
  int flags = 0;
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) flags |= kWVec;
  if (K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 8 == 0) flags |= kAVec;
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * esize) == 0) {
    flags |= kOVec;
  }
  unsigned* count = reinterpret_cast<unsigned*>(work + (size_t)M * N);
  lutmul_kernel<T, EPI><<<dim3((unsigned)g.gx, (unsigned)g.gy, g.gz),
                          T::THREADS, 0, s>>>(
      a, w, words, as, ws, out, work, count, M, K, N, g.k_chunk, flags);
  return (int)cudaGetLastError();
}

template <int EPI>
int dispatch(const uint8_t* a, const uint8_t* w, const uint32_t* words,
             const float* as, const float* ws, void* out, int32_t* work,
             int M, int K, int N, cudaStream_t s) {
  if (M <= kDecodeRows) {
    return launch<Decode, EPI>(a, w, words, as, ws, out, work, M, K, N, s);
  }
  return launch<Tall, EPI>(a, w, words, as, ws, out, work, M, K, N, s);
}

template <class T>
long long workspace_words(int M, int N) {
  const Geometry g = geometry<T>(M, 0, N);   // the tiles do not depend on K
  return (long long)M * N + g.gx * g.gy;
}

}  // namespace

// int32 words of the workspace a call at (M, N) needs: the [M, N] split
// sums, then one arrival counter per output tile.  It must be zero before
// the first call; every call leaves it zero.
extern "C" long long lutmul_workspace_words(int M, int N) {
  return M <= kDecodeRows ? workspace_words<Decode>(M, N)
                          : workspace_words<Tall>(M, N);
}

// table: the int32 [16] selection words (core/lut.py contraction_words)
extern "C" int lutmul_launch(const void* a, const void* w, const void* table,
                             const void* a_scale, const void* w_scale,
                             void* out, void* workspace, int M, int K, int N,
                             int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const uint8_t* w8 = static_cast<const uint8_t*>(w);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  int32_t* work = static_cast<int32_t*>(workspace);
  switch (epilogue) {
    case kInt32:
      return dispatch<kInt32>(a8, w8, t, as, ws, out, work, M, K, N, s);
    case kBf16:
      return dispatch<kBf16>(a8, w8, t, as, ws, out, work, M, K, N, s);
    case kF32:
      return dispatch<kF32>(a8, w8, t, as, ws, out, work, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
