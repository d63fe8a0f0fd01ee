// LUT gather on Hopper: acc[m, n] = sum_k T[w[k, n], a[m, k]], exactly one
// table read from shared memory per product.
//
// Replaces lutmul_pallas(impl="gather") (src/repro/kernels/lutmul/kernel.py
// :178, body _lutmul_gather_body :153): the TPU kernel's per-k jnp.take
// from the flat 256-entry table, kept as the A/B baseline (csrc/lutmul.cu
// is the kernel that serves).  Every product is one 32-bit load from the
// table in shared memory and one integer add, as there.  The sums are
// taken in uint32, so they wrap modulo 2^32 as XLA's int32 adds do and any
// [16, 16] int32 table is taken; for the product tables they are exact and
// equal lutmul.cu's int32 entry bit for bit.
//
// Layout: a [M, K] uint8 4-bit codes (the low nibble is read), w [K/2, N]
// uint8 nibble pairs (byte k2 holds w[2*k2] in its low nibble), table
// [16, 16] int32 with row = weight code, out [M, N] int32.
//
// Bound: not device memory.  The bytes, M*K + K*N/2 + 4*M*N (0.18 ms at
// 3.35 TB/s for MobileNetV2's 34 pointwise stages at batch 32), are few
// beside the M*K*N table reads, and shared memory returns 32 words a clock
// per SM.  The gather floor is M*K*N / (132 SMs * 32 a clock * f_SM):
// 1.03 ms for those stages (8.574e9 products) at 1,980 MHz.  The design
// aims at that floor:
//
// * No bank conflicts.  Lanes run along rows: the 16 lanes of a half-warp
//   hold 16 rows of the same 8 columns, so in each table read they share
//   the weight code w and differ in the activation code a.  The table is
//   staged with T[w, a] at word (w << 6) | (g << 4) | a for both halves g
//   of a warp (ref.gather_layout; the other words are never read).  The
//   bank is 16 g + a: distinct codes of a half-warp fall in distinct banks,
//   equal codes read one word as a broadcast, and the two halves, which
//   hold other columns, read disjoint banks.  Every warp-wide read is one
//   wavefront.
// * One instruction per address.  The word's byte offset is w << 8 |
//   g << 6 | a << 2: byte 1 is the weight code, byte 0 the activation code
//   with the half's bit.  Activation words are turned into such bytes once
//   per 4 codes, weight words into nibble bytes once per 4 columns; one
//   PRMT then takes a byte of each, and zeros for the top two bytes (the
//   sign of a byte whose top bit is clear).  The inner loop is PRMT, LDS
//   and half an IADD3 per product, with no global load.
// * Wide loads, each code reused.  Per 8-deep step a lane loads 8 bytes of
//   each of its R rows and the 8 weight bytes (8 columns) of each of 4 k2
//   rows, the next step's while it works on this one; each activation code
//   serves 8 columns, each weight code R rows.
// * Enough blocks, evenly.  Row tiles ride grid.x, so any M takes one
//   launch; 16-column tiles ride grid.y.  A block's 8 warps split into KG
//   groups along K (their sums meet in shared memory) and 8 / KG along
//   rows; the launch takes the least KG of 1, 2, 4, 8 that gives 5 blocks
//   an SM (the few-block stages: 1,568 rows meet 160 columns), each K
//   group keeping 4 steps.  Tall tile: 2 rows a lane; Short tile
//   (M <= 16): 1 row a lane, KG = 8.
//
// Measured on an H100 (scripts/gather_tiles.py, PERF.md §6): this step
// alone, on codes in registers, runs at 31.9 table reads a clock per SM,
// the floor's 32; the kernel reaches about three quarters of that at long
// K and less at K = 16-32, where each block's start and stores weigh.
// Staging the codes through shared memory with cp.async (also as a
// 4-deep ring under a persistent grid) measured no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;   // one table entry each when staging
constexpr int COLS = 8;               // columns a half-warp holds
constexpr int BN = 2 * COLS;          // columns a block holds
constexpr int KC = 8;                 // k per step
constexpr int MAX_GRID_Y = 65535;

template <int R_, int KG_, int MINB_>
struct Tile {
  static constexpr int R = R_;        // rows a lane holds, 16 apart
  static constexpr int KG = KG_;      // warps that split K
  static constexpr int MINB = MINB_;  // resident blocks per SM asked for
  static constexpr int WR = WARPS / KG;        // warps along rows
  static constexpr int BM = WR * 16 * R;       // rows a block holds
  static constexpr int RED = KG > 1 ? (KG - 1) * WR * R * COLS * 32 : 1;
};

using Tall = Tile<2, 1, 4>;         // KG here is the least; see launch
using Short = Tile<1, 8, 2>;
template <class T, int KG>
using Split = Tile<T::R, KG, T::MINB>;

// PTX prmt in its default mode: a selector nibble picks a byte of {y, x}
// with its low 3 bits and, with bit 3 set, gives that byte's sign instead.
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(s));
  return d;
}

// selector: byte 0 = byte i of x, byte 1 = byte j of y, bytes 2-3 = the
// sign of x's byte i (0: its top bit is clear)
__device__ __forceinline__ constexpr uint32_t sel(int i, int j) {
  return (uint32_t)(i | (4 + j) << 4 | (8 | i) << 8 | (8 | i) << 12);
}

template <class T>
struct Step {
  uint32_t x[T::R][2];   // activation bytes k0 .. k0+7 of each row
  uint32_t y[4][2];      // weight bytes of k2 = k0/2 + j, 8 columns
};

template <class T, bool VEC>
__device__ __forceinline__ void load_step(Step<T>& s,
                                          const uint8_t* const* arow,
                                          const uint8_t* __restrict__ w,
                                          int k0, int n0, int N) {
  if (VEC) {
#pragma unroll
    for (int r = 0; r < T::R; ++r) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(arow[r] + k0));
      s.x[r][0] = v.x;
      s.x[r][1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(
          w + (size_t)(k0 / 2 + j) * N + n0));
      s.y[j][0] = v.x;
      s.y[j][1] = v.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < T::R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v |= (uint32_t)__ldg(arow[r] + k0 + 4 * h + b) << (8 * b);
        s.x[r][h] = v;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = n0 + 4 * h + b;
          if (n < N)
            v |= (uint32_t)__ldg(w + (size_t)(k0 / 2 + j) * N + n) << (8 * b);
        }
        s.y[j][h] = v;
      }
  }
}

__device__ __forceinline__ uint32_t lds(const char* table, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(table + off);
}

template <class T>
__device__ __forceinline__ void gather_step(const Step<T>& s, const char* st,
                                            uint32_t gbits,
                                            uint32_t (&acc)[T::R][COLS]) {
  uint32_t t[T::R][2];
#pragma unroll
  for (int r = 0; r < T::R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      t[r][h] = ((s.x[r][h] << 2) & 0x3C3C3C3Cu) | gbits;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // k = 2j (low nibbles) and 2j + 1 (high nibbles): bytes i, i + 1 of
    // activation word j / 2
    const int i = 2 * (j & 1), h = j >> 1;
    uint32_t lo[2], hi[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      lo[q] = s.y[j][q] & 0x0F0F0F0Fu;
      hi[q] = (s.y[j][q] >> 4) & 0x0F0F0F0Fu;
    }
#pragma unroll
    for (int r = 0; r < T::R; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const uint32_t v0 = lds(st, prmt(t[r][h], lo[c >> 2], sel(i, c & 3)));
        const uint32_t v1 =
            lds(st, prmt(t[r][h], hi[c >> 2], sel(i + 1, c & 3)));
        acc[r][c] += v0 + v1;
      }
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(THREADS, T::MINB)
gather_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
              const int32_t* __restrict__ table, int32_t* __restrict__ out,
              int M, int K, int N) {
  __shared__ __align__(16) uint32_t s_t[16 * 64];
  __shared__ uint32_t s_red[T::RED];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 4;
  const int kg = warp % T::KG, wr = warp / T::KG;
  const long long row0 =
      (long long)blockIdx.x * T::BM + wr * 16 * T::R + (lane & 15);
  const int n0 = blockIdx.y * BN + g * COLS;
  // rows and columns past the edge read valid bytes and are not stored
  const int nl = (VEC && n0 >= N) ? 0 : n0;
  const uint8_t* arow[T::R];
#pragma unroll
  for (int r = 0; r < T::R; ++r) {
    const long long m = row0 + 16 * r;
    arow[r] = a + (m < M ? m : M - 1) * (long long)K;
  }
  const uint32_t gbits = g ? 0x40404040u : 0u;
  const char* st = reinterpret_cast<const char*>(s_t);
  uint32_t acc[T::R][COLS];
#pragma unroll
  for (int r = 0; r < T::R; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0;

  // the first step's loads fly while the table is staged
  const int steps = K / KC;
  int s = kg;
  Step<T> cur;
  if (s < steps) load_step<T, VEC>(cur, arow, w, s * KC, nl, N);
  {
    const uint32_t v = (uint32_t)table[tid];
    const int wc = tid >> 4, ac = tid & 15;
    s_t[wc * 64 + ac] = v;
    s_t[wc * 64 + 16 + ac] = v;
  }
  __syncthreads();
  for (; s < steps; s += T::KG) {
    Step<T> nxt = cur;
    if (s + T::KG < steps)
      load_step<T, VEC>(nxt, arow, w, (s + T::KG) * KC, nl, N);
    gather_step<T>(cur, st, gbits, acc);
    cur = nxt;
  }
  if (kg == 0) {
    for (int k = steps * KC; k < K; ++k) {   // K % 8: at most 6 k
      uint32_t wc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int n = n0 + c;
        wc[c] = n < N ? ((uint32_t)w[(size_t)(k >> 1) * N + n] >>
                         (4 * (k & 1))) & 0xFu
                      : 0u;
      }
#pragma unroll
      for (int r = 0; r < T::R; ++r) {
        const uint32_t tb = (((uint32_t)arow[r][k] & 0xFu) << 2) | (g << 6);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] += lds(st, (wc[c] << 8) | tb);
      }
    }
  }

  if (T::KG > 1) {
    // the K groups' sums meet in group 0 of their row group
    constexpr int PER = T::R * COLS;
    if (kg > 0) {
      uint32_t* dst = s_red + ((kg - 1) * T::WR + wr) * PER * 32 + lane;
#pragma unroll
      for (int r = 0; r < T::R; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) dst[(r * COLS + c) * 32] = acc[r][c];
    }
    __syncthreads();
    if (kg > 0) return;
    for (int q = 0; q < T::KG - 1; ++q) {
      const uint32_t* src = s_red + (q * T::WR + wr) * PER * 32 + lane;
#pragma unroll
      for (int r = 0; r < T::R; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] += src[(r * COLS + c) * 32];
    }
  }

  if (n0 >= N) return;
#pragma unroll
  for (int r = 0; r < T::R; ++r) {
    const long long m = row0 + 16 * r;
    if (m >= M) continue;
    int32_t* o = out + m * (long long)N + n0;
    if (VEC) {   // N % 8 == 0: all 8 columns exist, 16-byte aligned
      reinterpret_cast<int4*>(o)[0] =
          make_int4((int)acc[r][0], (int)acc[r][1], (int)acc[r][2],
                    (int)acc[r][3]);
      reinterpret_cast<int4*>(o)[1] =
          make_int4((int)acc[r][4], (int)acc[r][5], (int)acc[r][6],
                    (int)acc[r][7]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (n0 + c < N) o[c] = (int32_t)acc[r][c];
    }
  }
}

template <class T>
long long blocks(int M, int N) {
  return (M + (long long)T::BM - 1) / T::BM * ((N + BN - 1) / BN);
}

template <class T, bool VEC>
cudaError_t launch(const void* a, const void* w, const void* table, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + (long long)T::BM - 1) / T::BM),
                  (unsigned)((N + BN - 1) / BN));
  gather_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), M, K,
      N);
  return cudaGetLastError();
}

// the tall tile's K split: the least of 1, 2, 4, 8 that gives 5 blocks an
// SM, each K group keeping 4 steps (measured per MobileNetV2 stage with
// scripts/gather_tiles.py: within 0.3 % of the best split in the sum)
template <bool VEC>
cudaError_t launch_tall(const void* a, const void* w, const void* table,
                        void* out, int M, int K, int N, int sms,
                        cudaStream_t stream) {
  const long long want = 5LL * sms;
  const int steps = K / KC;
  if (steps < 4 * 2 || blocks<Split<Tall, 1>>(M, N) >= want)
    return launch<Split<Tall, 1>, VEC>(a, w, table, out, M, K, N, stream);
  if (steps < 4 * 4 || blocks<Split<Tall, 2>>(M, N) >= want)
    return launch<Split<Tall, 2>, VEC>(a, w, table, out, M, K, N, stream);
  if (steps < 4 * 8 || blocks<Split<Tall, 4>>(M, N) >= want)
    return launch<Split<Tall, 4>, VEC>(a, w, table, out, M, K, N, stream);
  return launch<Split<Tall, 8>, VEC>(a, w, table, out, M, K, N, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int lutmul_gather_launch(const void* a, const void* w,
                                    const void* table, void* out, int M,
                                    int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || K % 2 || (N + BN - 1) / BN > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % KC == 0 && N % COLS == 0 && aligned(a, 8) &&
                   aligned(w, 8) && aligned(out, 16);
  if (M <= 16)
    return (int)(vec ? launch<Short, true>(a, w, table, out, M, K, N, st)
                     : launch<Short, false>(a, w, table, out, M, K, N, st));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)(vec ? launch_tall<true>(a, w, table, out, M, K, N, sms, st)
                   : launch_tall<false>(a, w, table, out, M, K, N, sms, st));
}
