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
// Design (bf16 and fp16). The TPU kernel pads every operand to 128 lanes
// and runs a grid of (expert, row block, column block) steps, each one
// MXU dot over the whole (padded) K. Here one block owns a 128 x BN
// output tile of one expert (BN 128 or 256, picked by the wrapper) and
// walks K in 64-deep steps through a ring of shared-memory stages:
// - Loads: TMA. Each operand is a 3-D tensor map (fast dim with stride 1,
//   slow dim, expert), encoded on the host at each call; boxes are 64
//   elements (128 bytes) along the fast dim with the 128-byte swizzle.
//   Either dim of a and of b may be the fast one (the backward's swapped
//   operands w2^T, h^T, x^T, w1^T are views, not copies): the tile lands
//   K-major or MN-major and wgmma reads it through its transpose bits.
//   Boxes past the tensor's edge arrive as zeros, which gives the sums
//   the TPU kernel's zero padding gives (a capacity of 40, K = 200). An
//   operand TMA cannot describe is copied by the wrapper first
//   (ops/grouped_gemm.py::_gg_plan).
// - Pipeline: a ring of S stages, each with a full and an empty
//   mbarrier. Warpgroups 0 and 1 consume, each owning 64 rows: per stage
//   four wgmma.mma_async m64nBNk16 from shared-memory descriptors, one
//   group kept in flight, the previous stage released after
//   wgmma.wait_group. One thread of the producer after them issues the
//   stage's boxes. BN 256: 4 stages (192 KB), one block an SM, a
//   producer warpgroup that gives its registers to the consumers
//   (setmaxnreg). BN 128: 3 stages (96 KB), a producer warp, two blocks
//   an SM, so that one block's epilogue overlaps the other's loads and
//   products.
// - Epilogue (the TPU kernel's): z = round(acc + bias) to the storage
//   type; with an activation, round(gelu(z)) evaluated in fp32 on the
//   rounded z (tanh form, or erf for gelu_exact). The accumulators'
//   z go through the idle ring in shared memory, so that each lane then
//   writes 8 neighbouring outputs of a row with one 16-byte store where
//   N is a multiple of 8 (else element by element with masks), and the
//   activation runs in a short loop rather than unrolled over every
//   accumulator (that code outgrew the instruction cache).
// - No split-K and no atomics: each output element is one fixed sequence
//   of k16 products in k order, whatever the operands' layout or the
//   tile, so two launches give the same bits.
// A persistent schedule that overlaps one tile's epilogue with the next
// tile's loads is later work.
//
// fp32 (off the MoE path): fp32 FMA on a 64 x 64 tile (4 x 4 per thread),
// no TF32, operands read through their strides.
#include <cstdint>

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

using namespace dstt;

namespace {

constexpr int kBM = 128;            // rows of a block's tile
constexpr int kBK = 64;             // k of a stage: 128 bytes of 16-bit
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64;            // elements along a box's fast dim
constexpr int kBoxBytes = kBox * kBox * 2;   // one 64 x 64 box, 8 KB
constexpr int kATileBytes = kBM * kBK * 2;   // 16 KB

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

// The block's shape at each tile width. BN 256: 128 fp32 accumulators a
// consumer thread, so one block an SM; a producer warpgroup that hands
// registers to the consumers (setmaxnreg) and a 4-stage ring (192 KB).
// BN 128: 64 accumulators fit two blocks an SM (96 registers a thread of
// the 112 that 288 threads twice leave), one block's epilogue then
// overlapping the other's main loop; a producer warp and a 3-stage ring
// (96 KB) each.
template <int BN>
struct Ring {
  static constexpr bool kWide = BN == 256;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kATileBytes + kBBytes;
  static constexpr int kStages = kWide ? 4 : 3;
  static constexpr int kBlocksPerSM = kWide ? 1 : 2;
  static constexpr int kThreads = kConsumers + (kWide ? 128 : 32);
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB
  // pattern, and a full and an empty barrier a stage
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

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

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits(uint32_t v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xFFFFu));
}
template <>
__device__ __forceinline__ __half from_bits(uint32_t v) {
  return __ushort_as_half(static_cast<unsigned short>(v & 0xFFFFu));
}

// bf16/fp16 on TMA + wgmma. AM: a's fast dim is M (a M-major), else K.
// BK: b's fast dim is K (b K-major), else N.
template <typename T, int BN, bool AM, bool BK>
__global__ void __launch_bounds__(Ring<BN>::kThreads, Ring<BN>::kBlocksPerSM)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ bias,
                          T* __restrict__ out, int M, int K, int N, int act,
                          int vec_o) {
  using R = Ring<BN>;
  constexpr int S = R::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + S * R::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(full(s), 1);
      hop::mbar_init(empty(s), kConsumerWarps);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer, after the consumer warpgroups (wgmma wants each on a
    // 4-warp boundary): one thread keeps the ring full.
    if constexpr (R::kWide) hop::regs_dec<40>();
    if (threadIdx.x == kConsumers) {
      hop::tma_prefetch(&map_a);
      hop::tma_prefetch(&map_b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        hop::mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        hop::mbar_expect_tx(full(s), R::kStageBytes);
        const uint32_t sa = ring + s * R::kStageBytes;
        const uint32_t sb = sa + kATileBytes;
        const int k0 = kt * kBK;
        if (AM) {
          hop::tma_load_3d(sa, &map_a, full(s), m0, k0, e);
          hop::tma_load_3d(sa + kBoxBytes, &map_a, full(s), m0 + kBox, k0,
                           e);
        } else {
          hop::tma_load_3d(sa, &map_a, full(s), k0, m0, e);
        }
        if (BK) {
          hop::tma_load_3d(sb, &map_b, full(s), k0, n0, e);
        } else {
#pragma unroll
          for (int j = 0; j < BN / kBox; ++j)
            hop::tma_load_3d(sb + j * kBoxBytes, &map_b, full(s),
                             n0 + j * kBox, k0, e);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile.
    if constexpr (R::kWide) hop::regs_inc<232>();
    const int cw = threadIdx.x >> 7;
    hop::Acc<BN> acc;  // written first by the first product (acc_in 0)
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      hop::mbar_wait(full(s), (kt / S) & 1);
      // Both A layouts put rows 64 cw.. at 8 KB cw: the second half of a
      // K-major 128-row box, or the second 64-wide M-major box.
      const uint32_t sa = ring + s * R::kStageBytes + cw * kBoxBytes;
      const uint32_t sb = ring + s * R::kStageBytes + kATileBytes;
      hop::fence_acc(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // K-major: the next 16 k are 32 bytes on within each 128-byte row.
        // MN-major: 16 rows of 128 bytes on, two 8-row groups 1 KB apart.
        const uint64_t da =
            AM ? hop::smem_desc(sa + kk * 2048, kBoxBytes, 1024)
               : hop::smem_desc(sa + kk * 32, 16, 1024);
        const uint64_t db =
            BK ? hop::smem_desc(sb + kk * 32, 16, 1024)
               : hop::smem_desc(sb + kk * 2048, kBoxBytes, 1024);
        hop::mma_async<AM ? 1 : 0, BK ? 0 : 1>(acc, T(), da, db,
                                                kt > 0 || kk > 0);
      }
      hop::wgmma_commit();
      hop::fence_acc(acc);
      // The group before this one is done: its stage can be refilled.
      hop::wgmma_wait<1>();
      if (kt > 0 && (threadIdx.x & 31) == 0)
        hop::mbar_arrive(empty((kt - 1) % S));
    }
    hop::wgmma_wait<0>();
    hop::fence_acc(acc);
    if (nk == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0.f;
    }

    // Epilogue, in two passes through the ring, which no load or product
    // reads any more once both warpgroups are here. (1) Each warp rounds
    // z = acc + bias to T into its own 16 rows of shared memory (pitch BN
    // + 8 elements: the quad's pairs of 8 rows land on distinct banks).
    // (2) Each lane takes 8 neighbouring z of a row, applies the
    // activation and writes them with one 16-byte store where N is a
    // multiple of 8 (else element by element, masked). Both passes are
    // short loops, so the code stays in the instruction cache.
    hop::bar_sync(1, kConsumers);
    constexpr int kPitch = BN + 8;
    const int t = threadIdx.x & 127;
    const int w = t >> 5, lane = t & 31, q = lane & 3;
    T* stage =
        reinterpret_cast<T*>(smem_raw + (ring - hop::smem_u32(smem_raw))) +
        (4 * cw + w) * 16 * kPitch;
    const float* eb =
        bias != nullptr ? bias + static_cast<long long>(e) * N : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float b0 = eb != nullptr && n0 + c < N ? __ldg(eb + n0 + c) : 0.f;
      const float b1 =
          eb != nullptr && n0 + c + 1 < N ? __ldg(eb + n0 + c + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* d = acc.d + 4 * j + 2 * h;
        const T z0 = from_f32<T>(eb != nullptr ? d[0] + b0 : d[0]);
        const T z1 = from_f32<T>(eb != nullptr ? d[1] + b1 : d[1]);
        *reinterpret_cast<uint32_t*>(stage + ((lane >> 2) + 8 * h) * kPitch +
                                     c) = bits16(z0) | bits16(z1) << 16;
      }
    }
    __syncwarp();
    constexpr int kLanesPerRow = BN / 8;
    constexpr int kRowsPerPass = 32 / kLanesPerRow;
    const int cl = lane % kLanesPerRow;
    const int col = n0 + 8 * cl;
    T* oe = out + static_cast<long long>(e) * M * N;
#pragma unroll 1
    for (int r = lane / kLanesPerRow; r < 16; r += kRowsPerPass) {
      const int row = m0 + 64 * cw + 16 * w + r;
      if (row >= M || col >= N) continue;
      uint4 v = *reinterpret_cast<const uint4*>(stage + r * kPitch + 8 * cl);
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
      if (act != kActNone) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T lo = from_f32<T>(gelu(to_f32(from_bits<T>(u[i])), act));
          const T hi = from_f32<T>(gelu(to_f32(from_bits<T>(u[i] >> 16)), act));
          u[i] = bits16(lo) | bits16(hi) << 16;
        }
      }
      T* orow = oe + static_cast<long long>(row) * N + col;
      if (vec_o) {
        *reinterpret_cast<uint4*>(orow) = v;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col + i < N) orow[i] = from_bits<T>(u[i >> 1] >> (16 * (i & 1)));
      }
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


// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime
// so that the library links no -lcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a 16-bit operand: dims (fast, slow, experts), the fast
// dim's stride 1, the others' in elements; boxes of 64 x box_slow x 1 with
// the 128-byte swizzle, zeros past the edges. False where TMA cannot
// describe the operand (the wrapper's _gg_plan stages such an operand).
bool make_map(CUtensorMap* map, const void* base, int dtype, long long fast,
              long long slow, long long experts, long long s_slow,
              long long s_e, int box_slow) {
  const EncodeFn encode = encode_fn();
  if (encode == nullptr) return false;
  // A dim of size 1 is never stepped along: give it a valid stride.
  if (slow == 1) s_slow = (fast + 7) / 8 * 8;
  if (experts == 1) s_e = slow * s_slow;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(fast),
                              static_cast<cuuint64_t>(slow),
                              static_cast<cuuint64_t>(experts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_slow) * 2,
                                 static_cast<cuuint64_t>(s_e) * 2};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || s_slow <= 0 ||
      s_e <= 0 || strides[0] % 16 != 0 || strides[1] % 16 != 0)
    return false;
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_slow), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                dtype == kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN, bool AM, bool BK>
cudaError_t launch_tc(const CUtensorMap& map_a, const CUtensorMap& map_b,
                      const float* bias, void* out, int E, int M, int K,
                      int N, int act, cudaStream_t st) {
  auto kernel = grouped_gemm_wgmma_kernel<T, BN, AM, BK>;
  constexpr int smem = Ring<BN>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int vec_o =
      N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, E);
  kernel<<<grid, Ring<BN>::kThreads, smem, st>>>(map_a, map_b, bias,
                                       static_cast<T*>(out), M, K, N, act,
                                       vec_o);
  return cudaGetLastError();
}

template <typename T, int BN, typename... Args>
cudaError_t launch_majors(bool am, bool bk, Args... args) {
  if (am && bk) return launch_tc<T, BN, true, true>(args...);
  if (am) return launch_tc<T, BN, true, false>(args...);
  if (bk) return launch_tc<T, BN, false, true>(args...);
  return launch_tc<T, BN, false, false>(args...);
}

template <typename T, typename... Args>
cudaError_t launch_16(bool am, bool bk, int bn, Args... args) {
  return bn == 256 ? launch_majors<T, 256>(am, bk, args...)
                   : launch_majors<T, 128>(am, bk, args...);
}

}  // namespace

// bf16/fp16 (K9 on the MoE path). a: [E, M, K] with expert stride sae and
// slow stride sa_slow (elements); a_mn: a's fast (stride-1) dim is M, else
// K. b: [E, K, N] likewise, b_k: b's fast dim is K, else N. bias: [E, N]
// fp32 contiguous or null; out: [E, M, N] contiguous, of a's dtype.
// act: 0 none, 1 gelu_tanh, 2 gelu_exact; bn: the tile's width, 128 or
// 256. Operands TMA cannot describe return cudaErrorInvalidValue (the
// wrapper stages them).
extern "C" int dstt_grouped_gemm(const void* a, long long sae,
                                 long long sa_slow, int a_mn, const void* b,
                                 long long sbe, long long sb_slow, int b_k,
                                 const void* bias, void* out, int E, int M,
                                 int K, int N, int act, int dtype, int bn,
                                 void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || act < kActNone || act > kActExact || E > 65535 ||
      (M + kBM - 1) / kBM > 65535 || (bn != 128 && bn != 256) ||
      (dtype != kBFloat16 && dtype != kFloat16))
    return cudaErrorInvalidValue;
  const long long k = K > 0 ? K : 1;  // K = 0 loads nothing
  CUtensorMap ma, mb;
  const bool ok_a =
      a_mn ? make_map(&ma, a, dtype, M, k, E, sa_slow, sae, kBox)
           : make_map(&ma, a, dtype, k, M, E, sa_slow, sae, kBM);
  const bool ok_b =
      b_k ? make_map(&mb, b, dtype, k, N, E, sb_slow, sbe, bn)
          : make_map(&mb, b, dtype, N, k, E, sb_slow, sbe, kBox);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == kBFloat16)
    return launch_16<__nv_bfloat16>(a_mn, b_k, bn, ma, mb, bf, out, E, M, K,
                                    N, act, st);
  return launch_16<__half>(a_mn, b_k, bn, ma, mb, bf, out, E, M, K, N, act,
                           st);
}

// fp32: a [E, M, K] with element strides (sae, sam, sak); b [E, K, N] with
// (sbe, sbk, sbn); bias and out as above.
extern "C" int dstt_grouped_gemm_f32(const void* a, long long sae,
                                     long long sam, long long sak,
                                     const void* b, long long sbe,
                                     long long sbk, long long sbn,
                                     const void* bias, void* out, int E,
                                     int M, int K, int N, int act,
                                     void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || act < kActNone || act > kActExact || E > 65535 ||
      (M + kFBM - 1) / kFBM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, E);
  grouped_gemm_f32_kernel<<<grid, kFThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), sae, sam, sak,
      static_cast<const float*>(b), sbe, sbk, sbn,
      static_cast<const float*>(bias), static_cast<float*>(out), M, K, N,
      act);
  return cudaGetLastError();
}
