// Grouped GEMM of the MoE expert FFN: out[e] = act(a[e] @ b[e] + bias[e])
// for every expert e, a [E, M, K], b [E, K, N], bias [E, N] fp32 or none.
//
// Replaces (TPU, Pallas):
//   deepspeed_tpu/ops/grouped_gemm.py::_gg_kernel (K9), via _grouped_matmul
//
// Bound on an H100: operations. At the MoE training path's shapes (8
// experts, capacity 2560, hidden 768, FFN 3072, bf16) one launch is
// 2*E*M*K*N = 96.6 GFLOP, 98 us at 989 TFLOP/s, against 63-126 MB of
// operands and output, 19-38 us at 3.35 TB/s.
//
// Design. The TPU kernel pads every operand to 128 lanes and runs a grid
// of (expert, row block, column block) steps, each one MXU dot over the
// whole (padded) K. Here one block owns a 128 x 128 output tile of one
// expert and loops over K in 32-deep tiles:
// - Operands are read through their strides (each operand's own expert,
//   row and column strides), so the backward's swapped operands (w2^T,
//   h^T, x^T, w1^T) need no copy. The dimension with stride 1 is loaded
//   16 bytes a thread into shared memory, which holds the tile in that
//   orientation; the tensor-core fragments then read it row- or
//   column-major (four template variants). An operand with no unit
//   stride, or one not 16-byte aligned, is loaded element by element.
// - Ragged edges (M, K, N not multiples of the tile, a capacity of 40)
//   are loaded as zeros, which gives the sums the TPU kernel's zero
//   padding gives, and masked at the store.
// - bf16 and fp16: nvcuda::wmma 16x16x16 tiles with fp32 accumulators;
//   8 warps, each 64 x 32 of the output. The next K tile is fetched into
//   registers while the tensor cores work on the current one (two
//   shared-memory stages, one barrier per K tile).
// - fp32: fp32 FMA on a 64 x 64 tile (4 x 4 per thread), no TF32.
// - Epilogue (the TPU kernel's): z = round(acc + bias) to the storage
//   type; with an activation, round(gelu(z)) evaluated in fp32 on the
//   rounded z (tanh form, or erf for gelu_exact). Each lane writes 8
//   neighbouring outputs of a row with one 16-byte store where N is a
//   multiple of 8.
// - No split-K and no atomics: each output element is one thread's fixed
//   sequence of products, so two launches give the same bits.
// wgmma, TMA and a pipelined, persistent schedule are later work.
#include <cstdint>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

using namespace dstt;

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int kPad = 8;             // shared-memory row padding, elements
constexpr int kVec = 8;             // 16-bit elements in one 16-byte load

constexpr int kFBM = 64;            // fp32 tile
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;      // 16 x 16, 4 x 4 outputs each

constexpr int kActNone = 0;
constexpr int kActTanh = 1;
constexpr int kActExact = 2;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kSqrt2 = 1.4142135623730951f;

// _gelu_f32 of the TPU package, in fp32 (no fast-math).
__device__ __forceinline__ float gelu(float z, int act) {
  if (act == kActExact) return 0.5f * z * (1.f + erff(z / kSqrt2));
  const float u = kSqrt2OverPi * (z + kGeluC * z * z * z);
  return 0.5f * z * (1.f + tanhf(u));
}

template <typename T>
__device__ __forceinline__ T epilogue(float acc, const float* bias, int act) {
  const T z = from_f32<T>(bias != nullptr ? acc + *bias : acc);
  return act == kActNone ? z : from_f32<T>(gelu(to_f32(z), act));
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
}

// One operand tile of a 16-bit type, R rows along the operand's slow
// dimension by C elements along its fast one, staged in registers and
// stored to shared memory at pitch C + kPad. Element (r, c) is
// src[r * s_slow + c * s_fast] where r < r_ext and c < c_ext, else 0.
template <int R, int C>
struct TileLoad {
  static constexpr int kPerRow = C / kVec;
  static constexpr int kN = R * kPerRow / kThreads;
  static_assert(kN * kThreads == R * kPerRow, "tile not a multiple");
  uint4 reg[kN];

  __device__ __forceinline__ void fetch(const uint16_t* src,
                                        long long s_slow, long long s_fast,
                                        int r_ext, int c_ext, bool vec) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int r = v / kPerRow;
      const int c = (v - r * kPerRow) * kVec;
      if (vec && r < r_ext && c + kVec <= c_ext) {
        reg[i] = *reinterpret_cast<const uint4*>(src + r * s_slow + c);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (r < r_ext) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (c + j < c_ext) {
              const uint32_t bits = src[r * s_slow + (c + j) * s_fast];
              w[j >> 1] |= bits << (16 * (j & 1));
            }
          }
        }
        reg[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(uint16_t* dst) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int r = v / kPerRow;
      const int c = (v - r * kPerRow) * kVec;
      *reinterpret_cast<uint4*>(dst + r * (C + kPad) + c) = reg[i];
    }
  }
};

// bf16/fp16. TA: a's stride-1 dimension is M (tile stored [BK][BM],
// read column-major), else K ([BM][BK], row-major). TB: b's stride-1
// dimension is K ([BN][BK], column-major), else N ([BK][BN], row-major).
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ a, long long sae, long long sam,
                    long long sak, const T* __restrict__ b, long long sbe,
                    long long sbk, long long sbn,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int M, int K, int N, int act, bool vec_a, bool vec_b,
                    bool vec_o) {
  using namespace nvcuda;
  using LA = std::conditional_t<TA, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<TB, wmma::col_major, wmma::row_major>;
  constexpr int AR = TA ? kBK : kBM, AC = TA ? kBM : kBK;
  constexpr int BR = TB ? kBN : kBK, BC = TB ? kBK : kBN;
  constexpr int kAElems = AR * (AC + kPad);
  constexpr int kStage = kAElems + BR * (BC + kPad);
  constexpr int kScratch = (kThreads / 32) * 256 * sizeof(float);
  constexpr int kSmem = 2 * kStage * sizeof(T) > kScratch
                            ? 2 * kStage * sizeof(T) : kScratch;
  // Two stages of (A tile, B tile); the epilogue reuses the space as one
  // 16 x 16 fp32 scratch tile per warp. Every piece starts at a multiple
  // of 32 bytes, as wmma wants.
  __shared__ __align__(128) unsigned char smem[kSmem];
  uint16_t* stage0 = reinterpret_cast<uint16_t*>(smem);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const uint16_t* ae = reinterpret_cast<const uint16_t*>(a) + e * sae +
                       m0 * sam;
  const uint16_t* be = reinterpret_cast<const uint16_t*>(b) + e * sbe +
                       n0 * sbn;

  TileLoad<AR, AC> la;
  TileLoad<BR, BC> lb;
  auto fetch = [&](int k0) {
    if (TA)
      la.fetch(ae + k0 * sak, sak, sam, K - k0, M - m0, vec_a);
    else
      la.fetch(ae + k0 * sak, sam, sak, M - m0, K - k0, vec_a);
    if (TB)
      lb.fetch(be + k0 * sbk, sbn, sbk, N - n0, K - k0, vec_b);
    else
      lb.fetch(be + k0 * sbk, sbk, sbn, K - k0, N - n0, vec_b);
  };
  auto put = [&](int s) {
    la.store(stage0 + s * kStage);
    lb.store(stage0 + s * kStage + kAElems);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBK);
    const T* sa = reinterpret_cast<const T*>(stage0 + cur * kStage);
    const T* sb = reinterpret_cast<const T*>(stage0 + cur * kStage +
                                             kAElems);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16;
        if (TA)
          wmma::load_matrix_sync(fa[i], sa + kk * (AC + kPad) + r, AC + kPad);
        else
          wmma::load_matrix_sync(fa[i], sa + r * (AC + kPad) + kk, AC + kPad);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn + j * 16;
        if (TB)
          wmma::load_matrix_sync(fb[j], sb + c * (BC + kPad) + kk, BC + kPad);
        else
          wmma::load_matrix_sync(fb[j], sb + kk * (BC + kPad) + c, BC + kPad);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < nk) put(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: each warp's fragments through its scratch tile; a lane
  // writes 8 consecutive columns of one row.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
  const float* be_bias = bias != nullptr
                             ? bias + static_cast<long long>(e) * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm + i * 16 + r;
      const int gn0 = n0 + wn + j * 16 + c0;
      if (gm < M) {
        T* orow = out + (static_cast<long long>(e) * M + gm) * N;
        const float* v = scratch + r * 16 + c0;
        if (vec_o && gn0 + 8 <= N) {
          // 8 outputs in one 16-byte store (vec_o: N a multiple of 8 and
          // the bias 16-byte aligned, so rows and bias runs are too).
          float bv[8];
          if (be_bias != nullptr) {
            const float4 b0 = *reinterpret_cast<const float4*>(be_bias + gn0);
            const float4 b1 =
                *reinterpret_cast<const float4*>(be_bias + gn0 + 4);
            bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
            bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
          }
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int q = 0; q < 8; ++q)
            w[q >> 1] |= bits16(epilogue<T>(
                             v[q], be_bias != nullptr ? bv + q : nullptr,
                             act))
                         << (16 * (q & 1));
          *reinterpret_cast<uint4*>(orow + gn0) =
              make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int gn = gn0 + q;
            if (gn < N)
              orow[gn] = epilogue<T>(
                  v[q], be_bias != nullptr ? be_bias + gn : nullptr, act);
          }
        }
      }
      __syncwarp();
    }
  }
}

// fp32: k-major shared tiles, each thread a 4 x 4 patch of the 64 x 64
// output, products summed in k order with fmaf.
__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32_kernel(const float* __restrict__ a, long long sae,
                        long long sam, long long sak,
                        const float* __restrict__ b, long long sbe,
                        long long sbk, long long sbn,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int M, int K, int N,
                        int act) {
  __shared__ float sA[kFBK][kFBM + 4];
  __shared__ float sB[kFBK][kFBN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* ae = a + e * sae;
  const float* be = b + e * sbe;
  // Neighbouring threads walk the operand's stride-1 dimension.
  const bool a_mfast = sam == 1 && sak != 1;
  const bool b_kfast = sbk == 1 && sbn != 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    for (int idx = threadIdx.x; idx < kFBM * kFBK; idx += kFThreads) {
      const int m = a_mfast ? idx % kFBM : idx / kFBK;
      const int k = a_mfast ? idx / kFBM : idx % kFBK;
      const int gm = m0 + m, gk = k0 + k;
      sA[k][m] = (gm < M && gk < K) ? ae[gm * sam + gk * sak] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kFBN * kFBK; idx += kFThreads) {
      const int n = b_kfast ? idx / kFBK : idx % kFBN;
      const int k = b_kfast ? idx % kFBK : idx / kFBN;
      const int gn = n0 + n, gk = k0 + k;
      sB[k][n] = (gn < N && gk < K) ? be[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* be_bias = bias != nullptr
                             ? bias + static_cast<long long>(e) * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    float* orow = out + (static_cast<long long>(e) * M + gm) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N)
        orow[gn] = epilogue<float>(
            acc[i][j], be_bias != nullptr ? be_bias + gn : nullptr, act);
    }
  }
}

// 16-byte loads along the stride-1 dimension need that dimension's
// stride to be 1, the other two strides to be multiples of 8 elements
// and the base 16-byte aligned.
bool vec_ok(const void* p, long long unit, long long s1, long long s2) {
  return unit == 1 && s1 % kVec == 0 && s2 % kVec == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch_16(const void* a, long long sae, long long sam, long long sak,
               const void* b, long long sbe, long long sbk, long long sbn,
               const float* bias, void* out, int E, int M, int K, int N,
               int act, cudaStream_t st) {
  const bool ta = sam == 1 && sak != 1;
  const bool tb = sbk == 1 && sbn != 1;
  const bool va = ta ? vec_ok(a, sam, sae, sak) : vec_ok(a, sak, sae, sam);
  const bool vb = tb ? vec_ok(b, sbk, sbe, sbn) : vec_ok(b, sbn, sbe, sbk);
  const bool vo = N % kVec == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
#define DSTT_GG_LAUNCH(TA_, TB_)                                             \
  grouped_gemm_kernel<T, TA_, TB_><<<grid, kThreads, 0, st>>>(              \
      pa, sae, sam, sak, pb, sbe, sbk, sbn, bias, po, M, K, N, act, va, vb, \
      vo)
  if (ta && tb)
    DSTT_GG_LAUNCH(true, true);
  else if (ta)
    DSTT_GG_LAUNCH(true, false);
  else if (tb)
    DSTT_GG_LAUNCH(false, true);
  else
    DSTT_GG_LAUNCH(false, false);
#undef DSTT_GG_LAUNCH
}

}  // namespace

// a: [E, M, K] with element strides (sae, sam, sak); b: [E, K, N] with
// (sbe, sbk, sbn); bias: [E, N] fp32 contiguous or null; out: [E, M, N]
// contiguous, of a's dtype. act: 0 none, 1 gelu_tanh, 2 gelu_exact.
extern "C" int dstt_grouped_gemm(const void* a, long long sae, long long sam,
                                 long long sak, const void* b, long long sbe,
                                 long long sbk, long long sbn,
                                 const void* bias, void* out, int E, int M,
                                 int K, int N, int act, int dtype,
                                 void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || act < kActNone || act > kActExact || E > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == kFloat32) {
    if ((M + kFBM - 1) / kFBM > 65535) return cudaErrorInvalidValue;
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, E);
    grouped_gemm_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(a), sae, sam, sak,
        static_cast<const float*>(b), sbe, sbk, sbn, bf,
        static_cast<float*>(out), M, K, N, act);
  } else if ((M + kBM - 1) / kBM > 65535) {
    return cudaErrorInvalidValue;
  } else if (dtype == kBFloat16) {
    launch_16<__nv_bfloat16>(a, sae, sam, sak, b, sbe, sbk, sbn, bf, out, E,
                             M, K, N, act, st);
  } else if (dtype == kFloat16) {
    launch_16<__half>(a, sae, sam, sak, b, sbe, sbk, sbn, bf, out, E, M, K,
                      N, act, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
