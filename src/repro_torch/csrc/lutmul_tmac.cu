// T-MAC bitplane multiply on Hopper's int8 tensor cores:
//   acc[m, n] = sum_b coeff_b * sum_k a[m, k] * plane_b[k, n]
//               + const * sum_k a[m, k]
//             = sum_k a[m, k] * w[k, n],  w = sum_b coeff_b * plane_b + const
//
// Replaces the Pallas kernels lutmul_tmac_pallas and lutmul_tmac_fused_pallas
// (src/repro/kernels/lutmul/kernel.py:289 and :430; block math
// _tmac_contract / _tmac_block, :213-275).  The TPU version builds one-hot
// operands over partial-sum tables for an MXU dot; here each block decodes
// the planes back into the int8 weight codes w in registers and contracts
// them once, with mma.sync.m16n8k32 s8 x s8 -> s32 (exact integer sums,
// bitwise equal to kernels/lutmul/ref.py).  The fused entry point then
// writes ((float)acc * a_scale[m]) * w_scale[n], rounded with
// __float2bfloat16_rn.
//
// Layout: a [M, K] int8 signed activation codes; planes [P, K/8, N] uint8
// (bit i of byte j is plane row 8j + i), P <= 4; the per-plane
// coefficients and the additive const are kernel arguments and must be one
// of core/lut.py's plane decompositions (WEIGHT_BITS_SPECS): two's
// complement (1, 2, .., -2^(P-1)) for P = 2..4 (the drafter's top-plane
// suffixes are such stacks), ternary (1, -1), or w1 (2) with const -1.
// K % 8 == 0; M, N and the last K tile may be ragged.  g (1 or 2) names the
// reference's table width; the integer sums do not depend on it.
//
// Bound on the H100: bytes.  At decode (M = 8) and at the speculative
// verify (M = 32) the P*K*N/8 plane bytes dominate: 116 MB per qwen2-7b
// layer at P = 4, 0.035 ms at 3.35 TB/s; the 2*M*K*N int8 operations take
// a tenth of that at the tensor cores' peak.  Next comes the decode on the
// integer pipe (64 lanes per clock per SM, about 14.8e12 ops/s at
// 1.75 GHz).  What the design does about it:
//  * w fits int8 for every spec ([-8, 7], {-1, 0, 1}, {-1, 1}): ONE mma
//    per 32-deep step whatever P, in place of P table passes;
//  * the decode is word-wide.  A lane's A fragments of one step are the 4
//    adjacent columns 4g .. 4g+3 at k = 8*tig .. +7: one byte of each
//    plane per column, one 32-bit shared load per plane.  The spec's map
//    turns the P plane words into two's-complement bit slots (ternary
//    p0 - p1 is the 2-bit code (p1 & ~p0, p0 ^ p1); w1's 2p - 1 the code
//    (~p, 1)), top-aligned in each 4-bit nibble, 4 slot words s[0..3].
//    Two delta-swap rounds between slot words (5 ops per pair, 4 pairs)
//    transpose (slot, k) inside every nibble of all 4 columns at once;
//    8 byte permutes (the 4 x 4 byte transpose) give each column one word
//    whose nibble h of byte i is its code at k = 8*tig + 4h + i; one AND
//    (high nibbles) and a shift plus an AND (low nibbles) make its two A
//    registers.  40 integer ops per lane and step at P = 4, 1.25 per
//    weight: 11.8e12 weights/s against the 6.7e12 the bytes bring.  At
//    P = 2 (36 ops: two slot words are zero) the decode and the bytes are
//    about even, 13.2e12 against 13.4e12 weights/s;
//  * each code lands in the TOP bits of its byte, so an A byte holds
//    w << SHIFT (SHIFT = 8 - the slot count: 4 at P = 4, 5 at P = 3, 6 for
//    P = 2, ternary and w1) with the sign bit where int8 wants it, and no
//    sign extension is needed: |w << SHIFT| <= 128, so a partial sum over
//    up to 2^16 k stays exact in int32, and acc >> SHIFT is the sum.  K
//    chunks are capped at 2^16 (longer K always splits);
//  * int_matmul.cu's skeleton: weight columns on the instruction's 16-row
//    side, activation rows on its 8-column side; one block over up to 32
//    rows (four 8-row tiles sharing each decoded fragment), so for every
//    M <= 32 each plane byte leaves device memory once; taller M rides
//    grid.x in 32-row tiles; the P plane rows and the activation rows of a
//    stage stream through a ring of 16-byte cp.async.cg; a lane's
//    k slots 4*tig .. +3 and 16 + 4*tig .. +3 carry k = 8*tig .. +7 of the
//    step, so its B fragments are one 8-byte load of an activation row;
//    plane rows XOR-swizzled in 16-byte chunks by row % 4 and activation
//    rows padded to BK + 32 bytes keep both shared reads conflict-free;
//  * when the column tiles leave the card idle (fewer than a wave of
//    blocks), K is split over grid.z: each split adds its (unscaled)
//    partial sums into an int32 workspace with atomicAdd, the last block of
//    a tile to arrive writes the epilogue and re-zeroes the sums and its
//    arrival counter.  One launch per call; the workspace is left zero.
// Zero-filled K tails are exact: a zero plane byte decodes to 0, or to -1
// under w1, against zero-filled activations.  Planes or activations whose
// base is not 16-byte aligned, N or K not a multiple of 16, take byte loads
// into the same stages (right, not fast).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };
enum Flags { kWVec = 1, kAVec = 2, kOVec = 4 };
// the plane decompositions of core/lut.py
enum Spec { kTwos = 0, kTernary = 1, kBinary = 2 };

constexpr int kDecodeRows = 8;        // the one-row-tile block up to here
constexpr int kMaxChunk = 1 << 16;    // k per block: scaled sums stay exact

// TM 8-row tiles per block; WARPS warps, each over 32 columns; BK k per
// stage; STAGES stages in the ring; MINB blocks per SM; at most TARGET
// blocks once K is split (one wave).
template <int TM_, int WARPS_, int BK_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int TM = TM_, WARPS = WARPS_, BK = BK_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int TARGET = 132 * MINB;
  static constexpr int BM = 8 * TM;
  static constexpr int BN = 32 * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RJ = BK / 8;                // plane byte rows
  static constexpr int SA = BK + 32;               // activation row stride
  __host__ __device__ static constexpr int stage(int P) {
    return P * RJ * BN + BM * SA;
  }
  __host__ __device__ static constexpr int smem(int P) {
    return STAGES * stage(P);
  }
  static_assert(WARPS >= 4, "the swizzle spans 8 chunks of a plane row");
  static_assert(BK % 64 == 0, "SA = BK + 32 is conflict-free for BK % 64 == 0");
};

// chosen by timing variants at the served layers (scripts/tmac_tiles.py):
// deep stages won in both blocks; at M = 32 a 128-deep Wide stage split K
// further, and each split adds the [M, N] int32 sums with atomics
using Decode = Tile<1, 4, 512, 3, 2>;   // M <= kDecodeRows
using Wide = Tile<4, 4, 256, 4, 2>;     // M > kDecodeRows

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// 16 bytes of src (byte i valid when ok(i)) as one uint4, zero elsewhere
template <class Ok>
__device__ __forceinline__ uint4 gather16(const uint8_t* src, Ok ok) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (ok(i)) v[i >> 2] |= (uint32_t)src[i] << (8 * (i & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// two's-complement bit slots after the spec's map, and the shift of the
// codes in their A bytes
template <int P, int SPEC>
struct Planes {
  static constexpr int SLOTS = SPEC == kTwos ? P : 2;
  static constexpr int SHIFT = 8 - SLOTS;
};

// swap the bits of x under mask M with the bits of y under M >> D
template <int D, uint32_t M>
__device__ __forceinline__ void swap_bits(uint32_t& x, uint32_t& y) {
  const uint32_t t = (x ^ (y << D)) & M;
  x ^= t;
  y ^= t >> D;
}

// A fragments of one 32-deep step from the lane's P plane words (byte c of
// w[p]: plane p of column 4g + c at k = 8*tig .. +7, bit i at k 8*tig + i):
// q[h][c] is column c at k = 8*tig + 4h .. +3, byte i = w << SHIFT
template <int P, int SPEC>
__device__ __forceinline__ void decode(const uint32_t (&w)[P],
                                       uint32_t (&q)[2][4]) {
  // s[x]: slot x (bit x of every nibble's code), top-aligned
  uint32_t s[4] = {0u, 0u, 0u, 0u};
  if constexpr (SPEC == kTwos) {
#pragma unroll
    for (int p = 0; p < P; ++p) s[4 - P + p] = w[p];
  } else if constexpr (SPEC == kTernary) {
    // p0 - p1 = (p0 ^ p1) - 2 (p1 & ~p0)
    s[2] = w[0] ^ w[1];
    s[3] = w[1] & ~w[0];
  } else {   // 2 p - 1 = 1 - 2 ~p
    s[2] = 0xFFFFFFFFu;
    s[3] = ~w[0];
  }
  // transpose (slot x, k i) inside every nibble: 2 x 2 blocks, then bits
  swap_bits<2, 0xCCCCCCCCu>(s[0], s[2]);
  swap_bits<2, 0xCCCCCCCCu>(s[1], s[3]);
  swap_bits<1, 0xAAAAAAAAu>(s[0], s[1]);
  swap_bits<1, 0xAAAAAAAAu>(s[2], s[3]);
  // nibble h of byte c of s[i]: column c's code at k = 8*tig + 4h + i;
  // byte transpose: t[c] byte i = byte c of s[i]
  const uint32_t lo01 = __byte_perm(s[0], s[1], 0x5140);
  const uint32_t lo23 = __byte_perm(s[2], s[3], 0x5140);
  const uint32_t hi01 = __byte_perm(s[0], s[1], 0x7362);
  const uint32_t hi23 = __byte_perm(s[2], s[3], 0x7362);
  const uint32_t t[4] = {__byte_perm(lo01, lo23, 0x5410),
                         __byte_perm(lo01, lo23, 0x7632),
                         __byte_perm(hi01, hi23, 0x5410),
                         __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q[0][c] = (t[c] << 4) & 0xF0F0F0F0u;
    q[1][c] = t[c] & 0xF0F0F0F0u;
  }
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

// partial sums of k in [blockIdx.z * k_chunk, ... + k_chunk) for rows
// blockIdx.x * BM .. and columns blockIdx.y * BN ..: written with the
// epilogue when gridDim.z is 1, else added into acc_ws (int32 [M, N]) and
// written by the tile's last-arriving block (count: one arrival counter per
// (blockIdx.y, blockIdx.x)); both zero on entry and on exit
template <class T, int P, int SPEC, int EPI>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
tmac_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ planes,
            const float* __restrict__ a_scale,
            const float* __restrict__ w_scale, void* __restrict__ out,
            int32_t* __restrict__ acc_ws, unsigned* __restrict__ count,
            int M, int K, int N, int k_chunk, int flags) {
  extern __shared__ __align__(128) uint8_t smem[];   // STAGES x [planes | a]
  __shared__ bool s_last;
  constexpr int BK = T::BK, BN = T::BN, SA = T::SA, RJ = T::RJ;
  constexpr int PB = P * RJ * BN;                     // plane bytes a stage
  constexpr int STAGE = T::stage(P);
  constexpr int SHIFT = Planes<P, SPEC>::SHIFT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int KB = K / 8;
  const int j_end = k_end / 8;
  const bool wvec = flags & kWVec;
  const bool avec = flags & kAVec;

  // stage st <- k tile kt: for each plane, byte rows j0 .. j0+RJ-1 x the
  // block's BN columns, 16-byte chunk c of row r at chunk c ^ 2 * (r % 4);
  // a rows m0 .. m0+BM-1 x the tile's k at stride SA; zero outside the
  // matrices and past k_end
  auto load_stage = [&](int st, int kt) {
    uint8_t* sp = smem + st * STAGE;
    uint8_t* sa = sp + PB;
    const int k0 = k_begin + kt * BK;
    const int j0 = k0 / 8;
    for (int i = tid; i < P * RJ * (BN / 16); i += T::THREADS) {
      const int c = i % (BN / 16);
      const int pr = i / (BN / 16);                   // p * RJ + r
      const int r = pr % RJ;
      const int j = j0 + r;
      const int n = n0 + 16 * c;
      uint8_t* dst = sp + pr * BN + 16 * (c ^ (2 * (r & 3)));
      const bool in = j < j_end && n < N;
      const uint8_t* src = planes + ((size_t)(pr / RJ) * KB + j) * N + n;
      if (wvec) {
        cp_async16(dst, in ? src : planes, in ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            gather16(src, [&](int b) { return in && n + b < N; });
      }
    }
    for (int i = tid; i < T::BM * (BK / 16); i += T::THREADS) {
      const int r = i / (BK / 16);
      const int c = i % (BK / 16);
      const int m = m0 + r;
      const int k = k0 + 16 * c;
      uint8_t* dst = sa + r * SA + 16 * c;
      const bool in = m < M && k < k_end;
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(a) + (size_t)m * K + k;
      if (avec) {
        cp_async16(dst, in ? src : reinterpret_cast<const uint8_t*>(a),
                   in ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            gather16(src, [&](int b) { return in && k + b < k_end; });
      }
    }
  };

  int32_t acc[T::TM][2][4];
#pragma unroll
  for (int j = 0; j < T::TM; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][t][r] = 0;
  // uniform per block: row tiles past the matrix idle
  bool row_ok[T::TM];
#pragma unroll
  for (int j = 0; j < T::TM; ++j) row_ok[j] = m0 + 8 * j < M;

  // the lane's plane words: byte row 4s + tig of each 32-deep step s (its
  // swizzle is 2*tig), columns 32*warp + 4g .. +3; its activation words:
  // row 8j + g, k = 8*tig .. +7 of the step
  const int w_lane = tig * BN
                     + 16 * ((2 * warp + (g >> 2)) ^ (2 * tig)) + 4 * (g & 3);
  const int a_lane = g * SA + 8 * tig;

  auto contract = [&](int st) {
    const uint8_t* sp = smem + st * STAGE;
    const uint8_t* sa = sp + PB;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      uint32_t w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        w[p] = *reinterpret_cast<const uint32_t*>(
            sp + (p * RJ + 4 * s) * BN + w_lane);
      }
      uint32_t q[2][4];
      decode<P, SPEC>(w, q);
#pragma unroll
      for (int j = 0; j < T::TM; ++j) {
        if (!row_ok[j]) continue;
        const uint2 b = *reinterpret_cast<const uint2*>(
            sa + a_lane + 8 * j * SA + 32 * s);
        // m16 tile t: row g is column 4g + 2t, row g+8 column 4g + 2t + 1
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_s8(acc[j][t], q[0][2 * t], q[0][2 * t + 1], q[1][2 * t],
                 q[1][2 * t + 1], b.x, b.y);
        }
      }
    }
  };

  // the ring: STAGES - 1 stages in flight while one is contracted; stage
  // kt % STAGES is refilled only after every warp passed the barrier that
  // follows its last read
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int next = kt + T::STAGES - 1;
    if (next < tiles) load_stage(next % T::STAGES, next);
    cp_async_commit();
    contract(kt % T::STAGES);
  }

  // lane (g, tig) holds, for rows 8j + 2*tig + r, columns 32*warp + 4g ..
  // +3: d[r] and d[2 + r] of tiles 0 and 1, each w << SHIFT summed
  const bool split = gridDim.z > 1;
  const bool ovec = flags & kOVec;
  const int n_lane = n0 + 32 * warp + 4 * g;
#pragma unroll
  for (int j = 0; j < T::TM; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 8 * j + 2 * tig + r;
      if (m >= M || n_lane >= N) continue;
      const int32_t v[4] = {acc[j][0][r] >> SHIFT, acc[j][0][2 + r] >> SHIFT,
                            acc[j][1][r] >> SHIFT,
                            acc[j][1][2 + r] >> SHIFT};
      if (split) {
        const size_t o = (size_t)m * N + n_lane;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (n_lane + t < N) atomicAdd(acc_ws + o + t, v[t]);
        }
      } else {
        store4<EPI>(out, a_scale, w_scale, m, n_lane, N, v, ovec);
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
  for (int i = tid; i < T::BM * BN / 4; i += T::THREADS) {
    const int m = m0 + i / (BN / 4);
    const int n = n0 + 4 * (i % (BN / 4));
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

// split K (in whole stages) while the grid stays within TARGET blocks, and
// always into chunks of at most kMaxChunk
template <class T>
Geometry geometry(int M, int K, int N) {
  const long long gx = (M + T::BM - 1) / T::BM;
  const long long gy = (N + T::BN - 1) / T::BN;
  const int chunks = (K + T::BK - 1) / T::BK;
  const long long tiles = std::max(1LL, gx * gy);
  const long long split =
      std::max(1LL, std::min(T::TARGET / tiles, (long long)chunks));
  const int per = std::min((int)((chunks + split - 1) / split),
                           kMaxChunk / T::BK);
  const int k_chunk = std::max(1, per) * T::BK;
  const int gz = std::max(1, (K + k_chunk - 1) / k_chunk);
  return {gx, gy, gz, k_chunk};
}

template <class T, int P, int SPEC, int EPI>
int launch(const int8_t* a, const uint8_t* w, const float* as,
           const float* ws, void* out, int32_t* work, int M, int K, int N,
           cudaStream_t s) {
  const Geometry g = geometry<T>(M, K, N);
  if (g.gx > 0x7FFFFFFFLL || g.gy > 65535 || g.gz > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int esize = EPI == kBf16 ? 2 : 4;
  int flags = 0;
  if (N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    flags |= kWVec;
  }
  if (K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0) {
    flags |= kAVec;
  }
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * esize) == 0) {
    flags |= kOVec;
  }
  auto kern = tmac_kernel<T, P, SPEC, EPI>;
  constexpr int SMEM = T::smem(P);
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned* count = reinterpret_cast<unsigned*>(work + (size_t)M * N);
  kern<<<dim3((unsigned)g.gx, (unsigned)g.gy, g.gz), T::THREADS, SMEM, s>>>(
      a, w, as, ws, out, work, count, M, K, N, g.k_chunk, flags);
  return (int)cudaGetLastError();
}

template <int P, int SPEC, int EPI>
int by_rows(const int8_t* a, const uint8_t* w, const float* as,
            const float* ws, void* out, int32_t* work, int M, int K, int N,
            cudaStream_t s) {
  if (M <= kDecodeRows) {
    return launch<Decode, P, SPEC, EPI>(a, w, as, ws, out, work, M, K, N, s);
  }
  return launch<Wide, P, SPEC, EPI>(a, w, as, ws, out, work, M, K, N, s);
}

template <int P, int SPEC>
int by_epilogue(int epi, const int8_t* a, const uint8_t* w, const float* as,
                const float* ws, void* out, int32_t* work, int M, int K,
                int N, cudaStream_t s) {
  switch (epi) {
    case kInt32:
      return by_rows<P, SPEC, kInt32>(a, w, as, ws, out, work, M, K, N, s);
    case kBf16:
      return by_rows<P, SPEC, kBf16>(a, w, as, ws, out, work, M, K, N, s);
    case kF32:
      return by_rows<P, SPEC, kF32>(a, w, as, ws, out, work, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the spec whose plane decomposition (core/lut.py) the arguments are, or -1
int spec_of(int P, const int (&co)[4], int cnst) {
  if (P == 1 && co[0] == 2 && cnst == -1) return kBinary;
  if (P == 2 && co[0] == 1 && co[1] == -1 && cnst == 0) return kTernary;
  if (P < 2 || P > 4 || cnst != 0) return -1;
  for (int p = 0; p < P; ++p) {
    if (co[p] != (p < P - 1 ? 1 << p : -(1 << p))) return -1;
  }
  return kTwos;
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
extern "C" long long lutmul_tmac_workspace_words(int M, int N) {
  return M <= kDecodeRows ? workspace_words<Decode>(M, N)
                          : workspace_words<Wide>(M, N);
}

// a: int8 [M, K]; planes: uint8 [P, K/8, N]; coefficients c0..c3 (the
// first P used) and const: a plane decomposition of core/lut.py; g in
// {1, 2}.
extern "C" int lutmul_tmac_launch(const void* a, const void* planes,
                                  const void* a_scale, const void* w_scale,
                                  void* out, void* workspace, int M, int K,
                                  int N, int P, int g, int c0, int c1, int c2,
                                  int c3, int cnst, int epilogue,
                                  void* stream) {
  const int co[4] = {c0, c1, c2, c3};
  const int spec = spec_of(P, co, cnst);
  if (K % 8 != 0 || (g != 1 && g != 2) || spec < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const uint8_t* w8 = static_cast<const uint8_t*>(planes);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  int32_t* work = static_cast<int32_t*>(workspace);
  if (spec == kBinary) {
    return by_epilogue<1, kBinary>(epilogue, a8, w8, as, ws, out, work, M, K,
                                   N, s);
  }
  if (spec == kTernary) {
    return by_epilogue<2, kTernary>(epilogue, a8, w8, as, ws, out, work, M,
                                    K, N, s);
  }
  switch (P) {
    case 2:
      return by_epilogue<2, kTwos>(epilogue, a8, w8, as, ws, out, work, M, K,
                                   N, s);
    case 3:
      return by_epilogue<3, kTwos>(epilogue, a8, w8, as, ws, out, work, M, K,
                                   N, s);
    default:
      return by_epilogue<4, kTwos>(epilogue, a8, w8, as, ws, out, work, M, K,
                                   N, s);
  }
}
