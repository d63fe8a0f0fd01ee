// int8 x int8 -> int32 matmul on Hopper's int8 tensor cores, with an
// optional fused dequant epilogue.
//
// Replaces the Pallas kernels int_matmul_pallas and int_matmul_fused_pallas
// (src/repro/kernels/lutmul/kernel.py:332 and :483).  On the main path it
// serves the w8a8 lm_head: a [M, K] int8 activation codes, w [K, N] int8
// weight codes (row-major, as serve/quantize.py stores the head),
// a_scale [M] / w_scale [N] float32; out[m, n] = acc, or
// ((float)acc * a_scale[m]) * w_scale[n] as bf16 or f32.
//
// Bound on the H100: bytes.  At decode (M = 8) and at the speculative
// verify (M = 32) the K*N weight bytes dominate: 545 MB for the qwen2-7b
// head, 0.16 ms at 3.35 TB/s; the 2*M*K*N int8 operations take under
// 0.02 ms at the tensor cores' peak.  What the design does about it:
//  * one block covers up to 32 rows (four 8-row tiles) of its columns, so
//    for every M <= 32 each weight byte leaves device memory once; taller
//    M rides grid.x in 32-row tiles (no row cap);
//  * mma.sync.m16n8k32 s8 x s8 -> s32 (exact integer sums) with weight
//    columns on the instruction's 16-row side and activation rows on its
//    8-column side: M = 8 is one n8 tile, M = 32 four that share the same
//    weight fragments;
//  * the weights and activations stream through a ring of 4 shared-memory
//    stages with 16-byte cp.async.cg (three in flight: over 100 KB per SM,
//    enough to keep HBM busy), one __syncthreads per stage;
//  * an A fragment needs 4 k of one weight column, and a 32-bit word of
//    row-major w holds 4 columns of one k: each lane reads 4 words (4 k x
//    its 4 adjacent columns) from shared memory and transposes them with 8
//    byte permutes.  A lane's k slots 4*tig .. +3 and 16 + 4*tig .. +3
//    carry k = 8*tig .. +7 of each 32-deep step (the same permutation for
//    A and B leaves the sum unchanged), so its B fragments are one 8-byte
//    load of an activation row.  The stage rows are XOR-swizzled in 16-byte
//    chunks by (k / 8) % 4, and the activation rows padded to BK + 32
//    bytes: both shared-memory reads are free of bank conflicts;
//  * a lane's 4 adjacent columns are rows g / g+8 of its two m16 tiles, so
//    its outputs are one 16-byte store per row (8 for bf16);
//  * when the column tiles leave the card idle (fewer than a wave of
//    blocks), K is split over grid.z as lutmul.cu does: each split adds into
//    an int32 workspace with atomicAdd, the last block of a tile to arrive
//    writes the epilogue and re-zeroes the sums and its arrival counter.
//    One launch per call; the workspace is left zero for the next one.
// A w or a whose base is not 16-byte aligned, N or K not a multiple of 16,
// take byte loads into the same stages (right, not fast).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Epilogue { kInt32 = 0, kBf16 = 1, kF32 = 2 };
enum Flags { kWVec = 1, kAVec = 2, kOVec = 4 };

constexpr int kDecodeRows = 8;   // the one-row-tile block up to here

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
  static constexpr int SA = BK + 32;               // activation row stride
  static constexpr int W_BYTES = BK * BN;
  static constexpr int STAGE = W_BYTES + BM * SA;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(WARPS >= 4, "the swizzle spans 8 chunks of a stage row");
  static_assert(BK % 64 == 0, "SA = BK + 32 is conflict-free for BK % 64 == 0");
};

// chosen by timing variants at the three served heads
// (scripts/int_matmul_tiles.py): at M = 8 a 128-deep stage beat a 64-deep
// one, and an unsplit K beat a split one at bitnet-3b's 250 column tiles
using Decode = Tile<1, 4, 128, 4, 3>;   // M <= kDecodeRows
using Wide = Tile<4, 4, 64, 4, 5>;      // M > kDecodeRows

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
__device__ __forceinline__ uint4 gather16(const int8_t* src, Ok ok) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (ok(i)) v[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
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
template <class T, int EPI>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
int_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ w_scale, void* __restrict__ out,
                  int32_t* __restrict__ acc_ws, unsigned* __restrict__ count,
                  int M, int K, int N, int k_chunk, int flags) {
  extern __shared__ __align__(128) uint8_t smem[];   // STAGES x [w | a]
  __shared__ bool s_last;
  constexpr int BK = T::BK, BN = T::BN, SA = T::SA;

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
  const bool wvec = flags & kWVec;
  const bool avec = flags & kAVec;

  // stage st <- k tile kt: w rows k0 .. k0+BK-1 x the block's BN columns,
  // 16-byte chunk c of row r at chunk c ^ 2 * ((r / 8) % 4); a rows m0 ..
  // m0+BM-1 x the same k at stride SA; zero outside the matrices and k_end
  auto load_stage = [&](int st, int kt) {
    uint8_t* sw = smem + st * T::STAGE;
    uint8_t* sa = sw + T::W_BYTES;
    const int k0 = k_begin + kt * BK;
    for (int i = tid; i < BK * BN / 16; i += T::THREADS) {
      const int r = i / (BN / 16);
      const int c = i % (BN / 16);
      const int k = k0 + r;
      const int n = n0 + 16 * c;
      uint8_t* dst = sw + r * BN + 16 * (c ^ (2 * ((r >> 3) & 3)));
      const bool in = k < k_end && n < N;
      const int8_t* src = w + (size_t)k * N + n;
      if (wvec) {
        cp_async16(dst, in ? src : w, in ? 16 : 0);
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
      const int8_t* src = a + (size_t)m * K + k;
      if (avec) {
        cp_async16(dst, in ? src : a, in ? 16 : 0);
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

  // the lane's weight words: rows 8*tig + i of each 32-deep step (their
  // swizzle is 2*tig), columns 32*warp + 4g .. +3; its activation words:
  // row 8j + g, k = 8*tig .. +7 of the step
  const int w_lane = 8 * tig * BN
                     + 16 * ((2 * warp + (g >> 2)) ^ (2 * tig)) + 4 * (g & 3);
  const int a_lane = g * SA + 8 * tig;

  auto contract = [&](int st) {
    const uint8_t* sw = smem + st * T::STAGE;
    const uint8_t* sa = sw + T::W_BYTES;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 32) {
      uint32_t r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        r[i] = *reinterpret_cast<const uint32_t*>(sw + w_lane
                                                  + (kc + i) * BN);
      }
      // q[h][c]: column 4g + c at k = 8*tig + 4h .. +3 (4 x 4 byte
      // transpose of r[4h .. 4h+3])
      uint32_t q[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo01 = __byte_perm(r[4 * h], r[4 * h + 1], 0x5140);
        const uint32_t lo23 = __byte_perm(r[4 * h + 2], r[4 * h + 3], 0x5140);
        const uint32_t hi01 = __byte_perm(r[4 * h], r[4 * h + 1], 0x7362);
        const uint32_t hi23 = __byte_perm(r[4 * h + 2], r[4 * h + 3], 0x7362);
        q[h][0] = __byte_perm(lo01, lo23, 0x5410);
        q[h][1] = __byte_perm(lo01, lo23, 0x7632);
        q[h][2] = __byte_perm(hi01, hi23, 0x5410);
        q[h][3] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int j = 0; j < T::TM; ++j) {
        if (!row_ok[j]) continue;
        const uint2 b = *reinterpret_cast<const uint2*>(
            sa + a_lane + 8 * j * SA + kc);
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
  // +3: d[r] and d[2 + r] of tiles 0 and 1
  const bool split = gridDim.z > 1;
  const bool ovec = flags & kOVec;
  const int n_lane = n0 + 32 * warp + 4 * g;
#pragma unroll
  for (int j = 0; j < T::TM; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 8 * j + 2 * tig + r;
      if (m >= M || n_lane >= N) continue;
      const int32_t v[4] = {acc[j][0][r], acc[j][0][2 + r], acc[j][1][r],
                            acc[j][1][2 + r]};
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

// split K (in whole stages) while the grid stays within TARGET blocks
template <class T>
Geometry geometry(int M, int K, int N) {
  const long long gx = (M + T::BM - 1) / T::BM;
  const long long gy = (N + T::BN - 1) / T::BN;
  const int chunks = (K + T::BK - 1) / T::BK;
  const long long tiles = std::max(1LL, gx * gy);
  const long long split =
      std::max(1LL, std::min(T::TARGET / tiles, (long long)chunks));
  const int per = (int)((chunks + split - 1) / split);
  const int k_chunk = std::max(1, per) * T::BK;
  const int gz = std::max(1, (K + k_chunk - 1) / k_chunk);
  return {gx, gy, gz, k_chunk};
}

template <class T, int EPI>
int launch(const int8_t* a, const int8_t* w, const float* as,
           const float* ws, void* out, int32_t* work, int M, int K, int N,
           cudaStream_t s) {
  const Geometry g = geometry<T>(M, K, N);
  if (g.gx > 0x7FFFFFFFLL || g.gy > 65535) return (int)cudaErrorInvalidValue;
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
  auto kern = int_matmul_kernel<T, EPI>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned* count = reinterpret_cast<unsigned*>(work + (size_t)M * N);
  kern<<<dim3((unsigned)g.gx, (unsigned)g.gy, g.gz), T::THREADS, T::SMEM,
         s>>>(a, w, as, ws, out, work, count, M, K, N, g.k_chunk, flags);
  return (int)cudaGetLastError();
}

template <int EPI>
int dispatch(const int8_t* a, const int8_t* w, const float* as,
             const float* ws, void* out, int32_t* work, int M, int K, int N,
             cudaStream_t s) {
  if (M <= kDecodeRows) {
    return launch<Decode, EPI>(a, w, as, ws, out, work, M, K, N, s);
  }
  return launch<Wide, EPI>(a, w, as, ws, out, work, M, K, N, s);
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
extern "C" long long int_matmul_workspace_words(int M, int N) {
  return M <= kDecodeRows ? workspace_words<Decode>(M, N)
                          : workspace_words<Wide>(M, N);
}

extern "C" int int_matmul_launch(const void* a, const void* w,
                                 const void* a_scale, const void* w_scale,
                                 void* out, void* workspace, int M, int K,
                                 int N, int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  int32_t* work = static_cast<int32_t*>(workspace);
  switch (epilogue) {
    case kInt32:
      return dispatch<kInt32>(a8, w8, as, ws, out, work, M, K, N, s);
    case kBf16:
      return dispatch<kBf16>(a8, w8, as, ws, out, work, M, K, N, s);
    case kF32:
      return dispatch<kF32>(a8, w8, as, ws, out, work, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
