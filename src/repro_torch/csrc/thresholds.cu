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
// 401,408, N = 96), 0.092 ms.  Beside the bytes, L compares an element.
// What the design does about it, for L <= 16 (uint2-uint4 codes; a
// template on L):
//
// * A streaming pass, 16 bytes a thread.  The tensor is a flat run of
//   vectors of VEC = 4 columns: one 16-byte load of acc and one 16-byte
//   store of codes each, with the streaming hints (__ldcs, __stcs): every
//   byte is touched once.  Lane i of block b holds position p = 32 b + i;
//   the block's 4 warps take vectors p, p + Q, p + 2Q, p + 3Q and step by
//   4Q, where Q is a multiple of the N / 4 vectors of a row.  So a warp's
//   lanes touch 32 neighbouring vectors (512 bytes) at any N % 4 == 0,
//   narrow rows included, and each thread keeps its 4 columns for life.
//   U = 4 vectors are in flight a thread: each vector's next load is
//   issued as soon as it is counted.
// * Thresholds in registers.  A thread loads its 4 x L thresholds and 4
//   signs once.  The block's 4 warps share their (at most 32) groups of 4
//   columns, so the block reads them once, coalesced, before its first
//   loads of acc, stages them in shared memory at an odd stride of 16-byte
//   units (no bank conflict) and each thread reads its own into registers.
//   No compare reads memory.
// * Compares on two pipes.  A compare is one FSET giving 1.0f or 0.0f
//   (false on NaN, so a NaN threshold or sign never counts) on the ALU
//   pipe, and the count a float add on the FMA pipe: 135 instructions a
//   vector, 60 FSET and 60 FADD of them.
// * One round of resident blocks: as many as fit on the card at once, or
//   fewer where a thread would have no vector, so the 1,568-row stages
//   spread over every SM and the big ones run long-lived threads (one
//   prologue each).
// * N % 4 != 0, or a tensor not 16-byte aligned (a view at an offset):
//   VEC = 1, the same kernel with 4-byte accesses, just as exact.
//
// Any other L, and a tensor of 2^31 vectors or more, takes the general
// kernel: a block takes 32 columns, one a lane, their thresholds in shared
// memory as [L][32].
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <utility>

namespace {

// ---------------------------------------------------------------------------
// the register path: L <= MAX_REG_L
// ---------------------------------------------------------------------------

constexpr int MAX_REG_L = 16;
constexpr int WARPS = 4;         // warps a block: layers over the same columns
constexpr int BLOCK = 32 * WARPS;
constexpr int U = 4;             // vectors in flight a thread
constexpr int WAVES = 1;         // at most this many rounds of resident blocks

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using I = int32_t;
  using F = float;
  static __device__ __forceinline__ int32_t at(const I& x, int) { return x; }
  static __device__ __forceinline__ float at(const F& x, int) { return x; }
  static __device__ __forceinline__ I make(const int32_t (&c)[1]) {
    return c[0];
  }
};
template <> struct Vec<4> {
  using I = int4;
  using F = float4;
  static __device__ __forceinline__ int32_t at(const I& x, int k) {
    return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
  }
  static __device__ __forceinline__ float at(const F& x, int k) {
    return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
  }
  static __device__ __forceinline__ I make(const int32_t (&c)[4]) {
    return make_int4(c[0], c[1], c[2], c[3]);
  }
};

// A group is the VEC columns of one vector: in device memory its VEC * L
// thresholds ([VEC][L], rows of thr) are L units of VEC floats, its signs
// one more.  A block stages its (at most 32) groups in shared memory at a
// stride of an odd number of units, so a quarter-warp's 16-byte reads (a
// warp's 4-byte reads) hit distinct banks.
template <int L>
__host__ __device__ constexpr int slot_units() { return (L + 1) | 1; }

// A group's thresholds t (L units) and signs s into registers: th[k][l]
// is row VEC * g + k, level l.
template <int L, int VEC>
__device__ __forceinline__ void unpack(const typename Vec<VEC>::F* t,
                                       const typename Vec<VEC>::F* s,
                                       float (&th)[VEC][L > 0 ? L : 1],
                                       float (&sg)[VEC]) {
  typename Vec<VEC>::F raw[L > 0 ? L : 1];
#pragma unroll
  for (int j = 0; j < L; ++j) raw[j] = t[j];
  const typename Vec<VEC>::F sv = *s;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sg[k] = Vec<VEC>::at(sv, k);
#pragma unroll
    for (int l = 0; l < L; ++l)
      th[k][l] = Vec<VEC>::at(raw[(k * L + l) / VEC], (k * L + l) % VEC);
  }
}

// 1.0f where a >= t, else 0.0f (false on NaN): one FSET on the ALU pipe.
__device__ __forceinline__ float ge(float a, float t) {
  float r;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(t));
  return r;
}

// The number of levels of t at or below a, every level compared; the sum
// runs in float adds from 2^23, on the FMA pipe beside the compares, and
// is the low bits of the result.
template <int L>
__device__ __forceinline__ int32_t count(float a, const float* t) {
  float q = 8388608.f;
#pragma unroll
  for (int l = 0; l < L; ++l) q += ge(a, t[l]);
  return __float_as_int(q) - 0x4B000000;
}

// Lane i of block b holds position p = 32 b + i, of group p % NG; the
// block's WARPS warps are layers: warp w takes vectors p + w Q, then steps
// by S = WARPS Q, with Q a multiple of NG, so every warp of a block keeps
// the same 32 groups and each thread its own for its whole life.
template <int L, int VEC>
__global__ void __launch_bounds__(BLOCK)
threshold_reg(const typename Vec<VEC>::I* __restrict__ acc,
              const typename Vec<VEC>::F* __restrict__ thr,
              const typename Vec<VEC>::F* __restrict__ sign,
              typename Vec<VEC>::I* __restrict__ out, int V, int NG,
              int Q) {
  using I = typename Vec<VEC>::I;
  using F = typename Vec<VEC>::F;
  constexpr int LR = L > 0 ? L : 1;
  constexpr int PU = slot_units<L>();
  extern __shared__ __align__(16) unsigned char s_raw[];
  F* s_grp = reinterpret_cast<F*>(s_raw);
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * 32 + lane;
  const int S = WARPS * Q;
  int v = p + (threadIdx.x >> 5) * Q;
  const bool live = p < Q;

  // the block's groups g0, g0 + 1, ... (mod NG): G of them, group g0 + s
  // in slot s.  Their thresholds are read first, so that they are staged
  // by the time the first vectors of acc arrive.
  constexpr int NI = (32 * (L + 1) + BLOCK - 1) / BLOCK;
  const int G = min(NG, 32);
  const int g0 = (int)(blockIdx.x * 32u % (unsigned)NG);
  F tv[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = threadIdx.x + i * BLOCK;
    if (c < G * (L + 1)) {
      const int j = c % (L + 1);
      int g = g0 + c / (L + 1);
      if (g >= NG) g -= NG;
      tv[i] = __ldg(j < L ? thr + (long long)g * L + j : sign + g);
    }
  }

  // the first step's loads fly while the thresholds are staged
  I x[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live && v + u * S < V) x[u] = __ldcs(acc + v + u * S);

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = threadIdx.x + i * BLOCK;
    if (c < G * (L + 1)) s_grp[c / (L + 1) * PU + c % (L + 1)] = tv[i];
  }
  __syncthreads();
  if (!live) return;
  float th[VEC][LR], sg[VEC];
  unpack<L, VEC>(s_grp + (lane % G) * PU, s_grp + (lane % G) * PU + L, th,
                 sg);

  for (; v < V; v += U * S) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v + u * S < V) {
        int32_t c[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          c[k] = count<L>(
              __fmul_rn(__int2float_rn(Vec<VEC>::at(x[u], k)), sg[k]), th[k]);
        __stcs(out + v + u * S, Vec<VEC>::make(c));
      }
      // the next step's vector u flies while the others are counted
      if (v + (U + u) * S < V) x[u] = __ldcs(acc + v + (U + u) * S);
    }
  }
}

struct Args {
  const void* acc;
  const void* thr;
  const void* sign;
  void* out;
  int M, N, L;
  cudaStream_t stream;
};

cudaError_t launch_general(const Args& a);

template <int L, int VEC>
cudaError_t launch_reg(const Args& a) {
  using I = typename Vec<VEC>::I;
  using F = typename Vec<VEC>::F;
  auto kern = threshold_reg<L, VEC>;
  const int NG = a.N / VEC;
  const long long V = (long long)a.M * NG;
  const size_t smem = (size_t)std::min(NG, 32) * slot_units<L>() * sizeof(F);
  // resident blocks an SM, at the most shared memory a launch takes
  static const int resident = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, BLOCK, (size_t)32 * slot_units<L>() * sizeof(F));
    return std::max(n, 1);
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = std::min<long long>((V + BLOCK - 1) / BLOCK,
                                         (long long)WAVES * resident * sms);
  blocks = std::max<long long>(blocks, (NG + 31) / 32);
  const long long Q = blocks * 32 / NG * NG;
  if (V + 2LL * U * WARPS * Q > INT_MAX)    // 32-bit indices in the kernel
    return launch_general(a);
  kern<<<(unsigned)blocks, BLOCK, smem, a.stream>>>(
      static_cast<const I*>(a.acc), static_cast<const F*>(a.thr),
      static_cast<const F*>(a.sign), static_cast<I*>(a.out), (int)V, NG,
      (int)Q);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int L>
cudaError_t launch_l(const Args& a) {
  const bool vec = a.N % 4 == 0 && aligned16(a.acc) && aligned16(a.thr) &&
                   aligned16(a.sign) && aligned16(a.out);
  return vec ? launch_reg<L, 4>(a) : launch_reg<L, 1>(a);
}

template <int... Ls>
cudaError_t launch_reg_any(const Args& a, std::integer_sequence<int, Ls...>) {
  using Fn = cudaError_t (*)(const Args&);
  static constexpr Fn table[] = {&launch_l<Ls>...};
  return table[a.L](a);
}

// ---------------------------------------------------------------------------
// the general path: any L, thresholds in shared memory
// ---------------------------------------------------------------------------

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

cudaError_t launch_general(const Args& a) {
  const int gx = (a.N + BN - 1) / BN;
  const int rows = (a.M + ROWS - 1) / ROWS;
  const int gy = std::max(1, std::min({rows, (TARGET_BLOCKS + gx - 1) / gx,
                                       MAX_GRID_Y}));
  const size_t smem = (size_t)(a.L + 1) * BN * sizeof(float);
  threshold_kernel<<<dim3(gx, gy), dim3(BN, ROWS), smem, a.stream>>>(
      static_cast<const int32_t*>(a.acc), static_cast<const float*>(a.thr),
      static_cast<const float*>(a.sign), static_cast<int32_t*>(a.out), a.M,
      a.N, a.L);
  return cudaGetLastError();
}

}  // namespace

// Shared memory bytes a launch with L levels needs at most (the wrapper
// keeps it under the 48 KB a launch gets without opting in).
extern "C" long long threshold_smem_bytes(int L) {
  if (L >= 0 && L <= MAX_REG_L)
    return 32LL * ((L + 1) | 1) * 4 * (long long)sizeof(float);
  return (long long)(L + 1) * BN * (long long)sizeof(float);
}

extern "C" int threshold_launch(const void* acc, const void* thr,
                                const void* sign, void* out, int M, int N,
                                int L, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const Args a{acc, thr, sign, out, M, N, L,
               static_cast<cudaStream_t>(stream)};
  if (L >= 0 && L <= MAX_REG_L)
    return (int)launch_reg_any(
        a, std::make_integer_sequence<int, MAX_REG_L + 1>{});
  return (int)launch_general(a);
}
