// Fused elementwise kernels of the transformer block: (residual add +)
// LayerNorm forward and backward, and the bias+GELU FFN epilogue forward
// and backward.
//
// Replaces (TPU, Pallas):
//   deepspeed_tpu/ops/fused_elementwise.py::_ln_fwd_kernel   (K3f)
//   deepspeed_tpu/ops/fused_elementwise.py::_ln_bwd_kernel   (K3b)
//   deepspeed_tpu/ops/fused_elementwise.py::_gelu_fwd_kernel (K4f)
//   deepspeed_tpu/ops/fused_elementwise.py::_gelu_bwd_kernel (K4b)
//
// Bound on an H100: memory bytes. LayerNorm forward reads rows*H and
// writes rows*H (twice each with the residual: x and delta in, s and y
// out); its backward reads s and dy (and gs) and writes dx. bias+GELU
// reads and writes rows*F forward; backward reads y and g and writes dz.
// The arithmetic is a few fp32 operations per element (a few tens for
// the GELU curve), below the card's rate.
//
// Design. The TPU kernels lane-pad H to 128 and mask the pad columns;
// here the ragged edge needs no padding.
// - LayerNorm (both directions): a warp owns a row at a time; its lanes
//   hold the row in 16-byte vectors (8 bf16/fp16 or 4 fp32 a lane a
//   vector, kNv vectors a lane, lane l holding vectors l, l + 32, ...),
//   so the row statistics (the mean, then the centred variance, exactly
//   as the reference computes them) are a tree over the lane's values
//   and warp shuffles: no shared memory and no barrier on the row path.
//   The grid is persistent and fixed by the row count alone (at most
//   132 times the blocks an SM of the instance; warp w of block b takes
//   rows b*kWarps + w + k*stride), so the row-to-warp map, and with it
//   every sum, is the same on every launch. Each warp streams its rows
//   through a ring of kStages rows in shared memory (cp.async, each lane
//   copying and reading back only its own vectors), so the next rows
//   are in flight while one reduces; the scale (and the forward's bias,
//   the backward's dscale/dbias sums) live in registers. A width-1
//   instance (a lane holds single elements, the next row prefetched into
//   registers) serves H that is not a multiple of the vector width and
//   pointers that are not 16-byte aligned.
// - LN forward: the residual sum is rounded to the storage dtype BEFORE
//   the statistics read it, which keeps `s` bit-equal to the unfused
//   `x + delta`; `s` is stored as its own vectors. Rows wider than H
//   1024 (16-bit; 512 for fp32 and width 1) read their vectors again
//   from device memory (the L1) in each of the three passes, with the
//   scale and bias read there too; with the residual a pass recomputes
//   `s` from x and delta (the same bits) rather than reading back what
//   it stored. Any H.
// - LN backward: mean and rstd are recomputed from `s` as the forward
//   computes them, never saved; four row sums (mean, variance, m1, m2).
//   Rows wider than H 1024 (16-bit; 512 for fp32) keep the scale and the
//   sums in shared memory instead and load a row at a time. At the end
//   a block adds its warps' sums as a tree in fp64 and writes one
//   partial row; a second kernel of the same call adds the partial rows
//   in fp64 and block order and rounds once. No atomics: dscale/dbias
//   are bit-repeatable, and their sum over the rows rounds about once.
// - GELU rounds z = y + b to the storage dtype first, then evaluates the
//   tanh form or the erf form (kExact; `gelu_exact`) and its derivative
//   in fp32 with tanhf / erff / expf, no fast-math, as the TPU kernels
//   do. Both directions give each thread one 16-byte column vector and a
//   run of rows (a 2-D grid: column vectors x row runs), with kUnroll
//   rows' loads in flight; the bias of its columns is loaded once into
//   registers, so no element pays a division or a modulo for its
//   column. A width-1 instance serves ragged F and unaligned pointers.
//   The backward's runs are longer (kGeluBwdRows rows), its next batch
//   of rows loads while one computes, and its 16-bit values convert in
//   pairs; a thread keeps the dbias sums of its columns in registers,
//   kGeluBwdSplit threads of a block walk adjacent runs of one column
//   vector and the block adds their sums into one partial row, and a
//   second kernel of the same call sums the partial rows in fp64 and
//   run order, rounding once. The erf form's derivative multiplies by
//   1/sqrt(2) and 1/sqrt(2 pi) where the reference divides.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "mma.cuh"

using namespace dstt;

namespace {

// Build settings, each at the value that read fastest on an H100 among
// the variants that profile_torch_elementwise.py builds: K3f's and K3b's
// warps a block, blocks an SM and ring depth (rows a warp stages in
// shared memory; 1 keeps the next row in registers instead); K4f's rows
// a thread and rows in flight; K4b's rows a thread, threads a column
// vector and rows in flight (the fastest over its tanh and erf forms
// together).
#ifndef DSTT_LN_FWD_WARPS
#define DSTT_LN_FWD_WARPS 8
#endif
#ifndef DSTT_LN_FWD_BLOCKS_PER_SM
#define DSTT_LN_FWD_BLOCKS_PER_SM 2
#endif
#ifndef DSTT_LN_FWD_STAGES
#define DSTT_LN_FWD_STAGES 3
#endif
#ifndef DSTT_LN_BWD_WARPS
#define DSTT_LN_BWD_WARPS 8
#endif
#ifndef DSTT_LN_BWD_BLOCKS_PER_SM
#define DSTT_LN_BWD_BLOCKS_PER_SM 1
#endif
#ifndef DSTT_LN_BWD_STAGES
#define DSTT_LN_BWD_STAGES 3
#endif
#ifndef DSTT_GELU_ROWS
#define DSTT_GELU_ROWS 4
#endif
#ifndef DSTT_GELU_UNROLL
#define DSTT_GELU_UNROLL 4
#endif
#ifndef DSTT_GELU_BWD_ROWS
#define DSTT_GELU_BWD_ROWS 32
#endif
#ifndef DSTT_GELU_BWD_SPLIT
#define DSTT_GELU_BWD_SPLIT 2
#endif
#ifndef DSTT_GELU_BWD_UNROLL
#define DSTT_GELU_BWD_UNROLL 4
#endif

constexpr int kMaxLnSmem = 48 * 1024;
constexpr int kLnFwdWarps = DSTT_LN_FWD_WARPS;
constexpr int kLnFwdThreads = 32 * kLnFwdWarps;
constexpr int kLnFwdStages = DSTT_LN_FWD_STAGES;
constexpr int kLnBwdWarps = DSTT_LN_BWD_WARPS;
constexpr int kLnBwdThreads = 32 * kLnBwdWarps;
// Blocks an SM that the rows up to H 1024 are built for (the register
// cap of their launch bounds), and the grid: that many blocks for each
// of an H100's 132 SMs, fixed here and never queried, so the partition
// of rows over warps depends on the shape alone.
constexpr int kLnBwdMinBlocks = DSTT_LN_BWD_BLOCKS_PER_SM;
constexpr int kLnBwdMaxBlocks = 132 * kLnBwdMinBlocks;
constexpr int kLnBwdMaxH = 2048;
constexpr int kGeluThreads = 128;
// Rows a K4f thread walks on the training path, and rows in flight.
constexpr int kGeluRows = DSTT_GELU_ROWS;
constexpr int kGeluUnroll = DSTT_GELU_UNROLL;
// K4b: rows a thread walks; threads a block that walk one column
// vector's adjacent runs (the block adds their dbias partials into one
// partial row of kGeluBwdRows * kGeluBwdSplit rows); rows a batch (one
// batch loads while the one before it computes).
constexpr int kGeluBwdRows = DSTT_GELU_BWD_ROWS;
constexpr int kGeluBwdSplit = DSTT_GELU_BWD_SPLIT;
constexpr int kGeluBwdUnroll = DSTT_GELU_BWD_UNROLL;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
// sqrt(2/pi) * 0.044715 and sqrt(2/pi) * 3 * 0.044715, folded in double:
// the tanh form's derivative evaluates u and du as one FMA each.
constexpr float kSqrt2OverPiC =
    static_cast<float>(0.7978845608028654 * 0.044715);
constexpr float kSqrt2OverPi3C =
    static_cast<float>(0.7978845608028654 * 3.0 * 0.044715);
constexpr float kSqrt2 = 1.4142135623730951f;
// 1/sqrt(2) and 1/sqrt(2 pi), rounded once from double: the erf form's
// derivative multiplies by them where the forward divides by sqrt(2)
// (an IEEE division is a dozen instructions; the product is within an
// fp32 ulp of the quotient, far inside the 2-ulp check).
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// kEpv elements of T, moved as one 16-byte access (or one element for the
// width-1 instances).
template <typename T, int kEpv>
struct alignas(sizeof(T) * kEpv) Pack {
  T e[kEpv];
};

template <typename T, int kEpv>
__device__ __forceinline__ Pack<T, kEpv> load_pack(const T* p) {
  static_assert(kEpv == 1 || sizeof(T) * kEpv == 16, "16-byte packs");
  Pack<T, kEpv> r;
  if constexpr (kEpv == 1) {
    r.e[0] = *p;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &u, 16);
  }
  return r;
}

template <typename T, int kEpv>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, kEpv>& v) {
  if constexpr (kEpv == 1) {
    *p = v.e[0];
  } else {
    uint4 u;
    memcpy(&u, &v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// kEpv consecutive floats of a parameter vector, as 16-byte loads where
// `vec16` says the vector's base is 16-byte aligned (p is then too).
template <int kEpv>
__device__ __forceinline__ void load_f32(float (&dst)[kEpv], const float* p,
                                         bool vec16) {
  if constexpr (kEpv % 4 == 0) {
    if (vec16) {
#pragma unroll
      for (int q = 0; q < kEpv / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(p)[q];
        dst[4 * q] = f.x;
        dst[4 * q + 1] = f.y;
        dst[4 * q + 2] = f.z;
        dst[4 * q + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < kEpv; ++e) dst[e] = p[e];
}

// _gelu_f32 / _dgelu_f32 of the TPU package, in fp32.
template <bool kExact>
__device__ __forceinline__ float gelu_f32(float z) {
  if constexpr (kExact) {
    return 0.5f * z * (1.f + erff(z / kSqrt2));
  } else {
    const float u = kSqrt2OverPi * (z + kGeluC * z * z * z);
    return 0.5f * z * (1.f + tanhf(u));
  }
}

// The derivative, in an FMA-friendly order: within a few fp32 ulps of
// the reference's expression (the 2-ulp check on the rounded dz and the
// fp32 1e-5 are three orders wider).
template <bool kExact>
__device__ __forceinline__ float dgelu_f32(float z) {
  if constexpr (kExact) {
    const float phi = expf(-0.5f * z * z) * kInvSqrt2Pi;
    return fmaf(z, phi, fmaf(0.5f, erff(z * kInvSqrt2), 0.5f));
  } else {
    // u = sqrt(2/pi) (z + c z^3), du = sqrt(2/pi) (1 + 3c z^2);
    // 0.5 (1 + t) + 0.5 z (1 - t^2) du.
    const float z2 = z * z;
    const float t = tanhf(z * fmaf(kSqrt2OverPiC, z2, kSqrt2OverPi));
    const float du = fmaf(kSqrt2OverPi3C, z2, kSqrt2OverPi);
    return fmaf(0.5f * (z * du), fmaf(-t, t, 1.f), fmaf(0.5f, t, 0.5f));
  }
}

// Two fp32 values rounded to the 16-bit type T (to nearest even) as one
// 32-bit pair, lo in the low half: a single conversion instruction.
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  uint32_t w;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&w, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&w, &v, 4);
  }
  return w;
}

// A pair of the 16-bit type T widened to fp32 (for bf16 a shift and a
// mask).
template <typename T>
__device__ __forceinline__ void unpack_pair(uint32_t w, float& lo,
                                            float& hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t l = w << 16, h = w & 0xffff0000u;
    memcpy(&lo, &l, 4);
    memcpy(&hi, &h, 4);
  } else {
    __half a, b;
    memcpy(&a, &w, 2);
    memcpy(&b, reinterpret_cast<const char*>(&w) + 2, 2);
    lo = __half2float(a);
    hi = __half2float(b);
  }
}

// z = y + b rounded to the storage dtype, widened back.
template <typename T>
__device__ __forceinline__ float gelu_input(T y, float b) {
  return to_f32(from_f32<T>(to_f32(y) + b));
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sums v[0..N) as a balanced tree (N a compile-time count): a lane's
// share of a row sum rounds about as often as a tree over the whole row.
template <typename F, int N>
__device__ __forceinline__ F tree_sum(F (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) v[j] += v[j + w];
  }
  return v[0];
}

// The lane's shares of two row sums over its valid vectors j: f(j, a, b)
// fills a[e] and b[e] for the vector's elements e; a tree over each
// vector, then over the vectors.
template <int kNv, int kEpv, typename Fn>
__device__ __forceinline__ void lane_sum2(int lane, int nvec, Fn f,
                                          float& sum_a, float& sum_b) {
  float pa[kNv], pb[kNv];
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    pa[j] = pb[j] = 0.f;
    if (j * 32 + lane < nvec) {
      float ea[kEpv], eb[kEpv];
      f(j, ea, eb);
      pa[j] = tree_sum(ea);
      pb[j] = tree_sum(eb);
    }
  }
  sum_a = tree_sum(pa);
  sum_b = tree_sum(pb);
}

// One row sum: lane_sum2 with f(j, a) filling a alone.
template <int kNv, int kEpv, typename Fn>
__device__ __forceinline__ float lane_sum(int lane, int nvec, Fn f) {
  float sum, unused;
  lane_sum2<kNv, kEpv>(
      lane, nvec,
      [&](int j, float (&ea)[kEpv], float (&eb)[kEpv]) {
        f(j, ea);
#pragma unroll
        for (int e = 0; e < kEpv; ++e) eb[e] = 0.f;
      },
      sum, unused);
  return sum;
}

// Loads the lane's vectors of one row of `src` (row offset `base`);
// vectors past the row's end read as zeros.
template <typename T, int kNv, int kEpv>
__device__ __forceinline__ void load_row(Pack<T, kEpv> (&dst)[kNv],
                                         const T* __restrict__ src,
                                         long long base, int lane,
                                         int nvec) {
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const int v = j * 32 + lane;
    if (v < nvec) {
      dst[j] = load_pack<T, kEpv>(src + base + v * kEpv);
    } else {
#pragma unroll
      for (int e = 0; e < kEpv; ++e) dst[j].e[e] = from_f32<T>(0.f);
    }
  }
}

// Rows a K3f warp loads ahead of the one it normalizes, plus one: none
// for the wide rows, the ring for 16-byte vectors, else one row in
// registers.
template <typename T, int kEpv, bool kWide>
__host__ __device__ constexpr int ln_fwd_stages() {
  return kWide ? 0 : (sizeof(T) * kEpv == 16 ? kLnFwdStages : 1);
}

// Blocks an SM a K3f instance is built for (the register cap of its
// launch bounds, and 132 times it the grid): the setting's count for the
// wide rows and for 16-byte vectors where a lane holds at most 24
// columns (H 768 of 16-bit values, the main path), else one, which
// leaves the wider rows' values, scale and bias (and the width-1
// instances' prefetched row) room in registers.
template <int kNv, int kEpv, bool kWide>
__host__ __device__ constexpr int ln_fwd_min_blocks() {
  return kWide || (kEpv > 1 && kNv * kEpv <= 24) ? DSTT_LN_FWD_BLOCKS_PER_SM
                                                 : 1;
}

// K3f. kNv vectors of kEpv elements a lane (kNv * kEpv * 32 >= H) hold
// the row as fp32 in registers, with the scale and bias of the lane's
// columns loaded once; the 16-byte instances stage x (and delta) through
// a ring of kStages rows a warp in shared memory with cp.async, kStages
// - 1 rows ahead (each lane copies and reads back only its own vectors,
// so the ring needs no barrier), the width-1 instances the next row
// into registers. kWide rows hold nothing in registers: each of the
// three passes reads the lane's vectors again from device memory.
// Warps a block: blockDim.x / 32 (fewer than kLnFwdWarps for few rows).
// Dynamic shared memory: the ring [warps][kStages][x (, delta)][H] of T.
template <typename T, bool kResid, int kNv, int kEpv, bool kWide>
__global__ void __launch_bounds__(kLnFwdThreads,
                                  ln_fwd_min_blocks<kNv, kEpv, kWide>())
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d,
              const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ s_out,
              T* __restrict__ y_out, int rows, int H, float eps) {
  using P = Pack<T, kEpv>;
  constexpr int kCols = kNv * kEpv;
  constexpr int kStages = ln_fwd_stages<T, kEpv, kWide>();
  constexpr bool kRing = kStages >= 2;
  constexpr int kArr = kResid ? 2 : 1;
  static_assert(!kRing || sizeof(T) * kEpv == 16, "the ring moves 16 bytes");
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nvec = H / kEpv;
  const float fH = static_cast<float>(H);
  const bool sb16 = ((reinterpret_cast<uintptr_t>(scale) |
                      reinterpret_cast<uintptr_t>(bias)) & 15u) == 0;
  const size_t row_bytes = static_cast<size_t>(H) * sizeof(T);
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4) +
                        static_cast<size_t>(warp) * kStages * kArr *
                            row_bytes;
  float sc[kWide ? 1 : kCols], bi[kWide ? 1 : kCols];
  if constexpr (!kWide) {
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int v = j * 32 + lane;
      float a[kEpv], c[kEpv];
      if (v < nvec) {
        load_f32<kEpv>(a, scale + v * kEpv, sb16);
        load_f32<kEpv>(c, bias + v * kEpv, sb16);
      }
#pragma unroll
      for (int e = 0; e < kEpv; ++e) {
        sc[j * kEpv + e] = v < nvec ? a[e] : 0.f;
        bi[j * kEpv + e] = v < nvec ? c[e] : 0.f;
      }
    }
  }
  // The ring: stage t holds one row of x (and delta).
  auto issue = [&](int row, int t) {
    if (row < rows) {
      const long long base = static_cast<long long>(row) * H;
      unsigned char* st = ring + static_cast<size_t>(t) * kArr * row_bytes;
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const int v = j * 32 + lane;
        if (v < nvec) {
          tc::cp_async16(st + v * 16, x + base + v * kEpv, true);
          if constexpr (kResid)
            tc::cp_async16(st + row_bytes + v * 16, d + base + v * kEpv,
                           true);
        }
      }
    }
    tc::cp_async_commit();
  };
  // s = round(x + delta) (or x) of one vector, as fp32 in a[].
  auto s_of = [&](const P& px, const P& pd, float(&a)[kEpv]) {
    P ps = px;
#pragma unroll
    for (int e = 0; e < kEpv; ++e) {
      if constexpr (kResid)
        ps.e[e] = from_f32<T>(to_f32(px.e[e]) + to_f32(pd.e[e]));
      a[e] = to_f32(ps.e[e]);
    }
    return ps;
  };

  const int stride = gridDim.x * warps;
  int r = blockIdx.x * warps + warp;
  P cx[kStages == 1 ? kNv : 1], cd[kStages == 1 ? kNv : 1];
  if constexpr (kRing) {
#pragma unroll
    for (int t = 0; t + 1 < kStages; ++t) issue(r + t * stride, t);
  } else if constexpr (kStages == 1) {
    if (r < rows) {
      load_row<T, kNv, kEpv>(cx, x, static_cast<long long>(r) * H, lane,
                             nvec);
      if constexpr (kResid)
        load_row<T, kNv, kEpv>(cd, d, static_cast<long long>(r) * H, lane,
                               nvec);
    }
  }
  for (int k = 0; r < rows; r += stride, ++k) {
    const long long base = static_cast<long long>(r) * H;
    if constexpr (kWide) {
      // Three passes over the lane's vectors v = lane, lane + 32, ...
      auto s_at = [&](int v, float(&a)[kEpv]) {
        const P px = load_pack<T, kEpv>(x + base + v * kEpv);
        P pd;
        if constexpr (kResid) pd = load_pack<T, kEpv>(d + base + v * kEpv);
        return s_of(px, pd, a);
      };
      float sum = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        float a[kEpv];
        const P ps = s_at(v, a);
        if constexpr (kResid) store_pack<T, kEpv>(s_out + base + v * kEpv, ps);
        sum += tree_sum(a);
      }
      const float mean = warp_sum(sum) / fH;
      float sq = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        float a[kEpv];
        s_at(v, a);
#pragma unroll
        for (int e = 0; e < kEpv; ++e) {
          const float c = a[e] - mean;
          a[e] = c * c;
        }
        sq += tree_sum(a);
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) / fH + eps);
      for (int v = lane; v < nvec; v += 32) {
        float a[kEpv], vs[kEpv], vb[kEpv];
        s_at(v, a);
        load_f32<kEpv>(vs, scale + v * kEpv, sb16);
        load_f32<kEpv>(vb, bias + v * kEpv, sb16);
        P o;
#pragma unroll
        for (int e = 0; e < kEpv; ++e)
          o.e[e] = from_f32<T>((a[e] - mean) * rstd * vs[e] + vb[e]);
        store_pack<T, kEpv>(y_out + base + v * kEpv, o);
      }
    } else {
      const long long nbase = base + static_cast<long long>(stride) * H;
      const bool more = r + stride < rows;
      P nx[kStages == 1 ? kNv : 1], nd[kStages == 1 ? kNv : 1];
      const unsigned char* st = ring;
      if constexpr (kRing) {
        // Refill the stage the previous row was read from, then wait for
        // this row's.
        issue(r + (kStages - 1) * stride, (k + kStages - 1) % kStages);
        tc::cp_async_wait<kStages - 1>();
        st = ring + static_cast<size_t>(k % kStages) * kArr * row_bytes;
      } else if (more) {
        load_row<T, kNv, kEpv>(nx, x, nbase, lane, nvec);
        if constexpr (kResid) load_row<T, kNv, kEpv>(nd, d, nbase, lane, nvec);
      }
      // The row as fp32, each vector read from the ring (or the
      // registers) as it is used; `s` stored as it is formed.
      float sv[kCols];
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const int v = j * 32 + lane;
        float a[kEpv];
        P px, pd;
        if constexpr (kRing) {
          if (v < nvec) {
            px = *reinterpret_cast<const P*>(st + v * 16);
            if constexpr (kResid)
              pd = *reinterpret_cast<const P*>(st + row_bytes + v * 16);
          }
        } else {
          px = cx[j];
          pd = cd[j];
        }
        const P ps = s_of(px, pd, a);
#pragma unroll
        for (int e = 0; e < kEpv; ++e) sv[j * kEpv + e] = a[e];
        if constexpr (kResid) {
          if (v < nvec) store_pack<T, kEpv>(s_out + base + v * kEpv, ps);
        }
      }
      const float mean =
          warp_sum(lane_sum<kNv, kEpv>(lane, nvec,
                                       [&](int j, float(&a)[kEpv]) {
#pragma unroll
                                         for (int e = 0; e < kEpv; ++e)
                                           a[e] = sv[j * kEpv + e];
                                       })) /
          fH;
      const float var =
          warp_sum(lane_sum<kNv, kEpv>(lane, nvec,
                                       [&](int j, float(&a)[kEpv]) {
#pragma unroll
                                         for (int e = 0; e < kEpv; ++e) {
                                           const float c =
                                               sv[j * kEpv + e] - mean;
                                           a[e] = c * c;
                                         }
                                       })) /
          fH;
      const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const int v = j * 32 + lane;
        if (v < nvec) {
          P o;
#pragma unroll
          for (int e = 0; e < kEpv; ++e) {
            const int c = j * kEpv + e;
            o.e[e] = from_f32<T>((sv[c] - mean) * rstd * sc[c] + bi[c]);
          }
          store_pack<T, kEpv>(y_out + base + v * kEpv, o);
        }
      }
      if constexpr (kStages == 1) {
        if (more) {
#pragma unroll
          for (int j = 0; j < kNv; ++j) {
            cx[j] = nx[j];
            cd[j] = nd[j];
          }
        }
      }
    }
  }
  if constexpr (kRing) tc::cp_async_wait<0>();
}

// Rows a K3b warp loads ahead of the one it reduces, plus one: none for
// the wide rows, the ring for 16-byte vectors, else one row in registers.
template <typename T, int kEpv, bool kWide>
__host__ __device__ constexpr int ln_bwd_stages() {
  return kWide ? 0 : (sizeof(T) * kEpv == 16 ? DSTT_LN_BWD_STAGES : 1);
}

// K3b. kNv vectors of kEpv elements a lane (kNv * kEpv * 32 >= H).
// Rows up to H 1024 (16-bit; 512 for fp32 and width 1) keep the scale
// and the per-lane dscale/dbias sums in registers, and load ahead:
// the 16-byte instances stage rows through a ring of kStages rows a warp
// in shared memory with cp.async, kStages - 1 rows ahead (each lane
// copies and reads back only its own vectors, so the ring needs no
// barrier), the width-1 instances the next row's `s` and `dy` into
// registers. kWide rows keep the scale and the sums (a slice a warp) in
// shared memory and hold no row in registers: each pass reads the
// lane's vectors again from device memory (the L1).
// Dynamic shared memory: with kWide the scale [H] and the warps' sums
// [kLnBwdWarps][2][H] of floats; otherwise the ring
// [kLnBwdWarps][kStages][s, dy (, gs)][H] of T, which the warps' sums
// overlay at the end.
template <typename T, bool kGs, int kNv, int kEpv, bool kWide>
__global__ void __launch_bounds__(kLnBwdThreads, kWide ? 1 : kLnBwdMinBlocks)
ln_bwd_kernel(const T* __restrict__ s, const float* __restrict__ scale,
              const T* __restrict__ dy, const T* __restrict__ gs,
              T* __restrict__ dx, double* __restrict__ part, int rows, int H,
              float eps) {
  using P = Pack<T, kEpv>;
  constexpr int kCols = kNv * kEpv;
  constexpr int kStages = ln_bwd_stages<T, kEpv, kWide>();
  constexpr bool kRing = kStages >= 2;
  constexpr int kArr = kGs ? 3 : 2;
  static_assert(!kRing || sizeof(T) * kEpv == 16, "the ring moves 16 bytes");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = H / kEpv;
  const float fH = static_cast<float>(H);

  float* sc_sm = smem;                                   // kWide: [H]
  // The warps' sums [kLnBwdWarps][2][H]: through the loop with kWide, at
  // the end (over the dead ring) otherwise.
  float* slots = smem + (kWide ? H : 0);
  float* acc_sm = slots + warp * 2 * H;
  const size_t row_bytes = static_cast<size_t>(H) * sizeof(T);
  unsigned char* ring = reinterpret_cast<unsigned char*>(slots) +
                        static_cast<size_t>(warp) * kStages * kArr *
                            row_bytes;
  float sc[kWide ? 1 : kCols];
  float acc_s[kWide ? 1 : kCols], acc_b[kWide ? 1 : kCols];
  if constexpr (kWide) {
    for (int c = threadIdx.x; c < H; c += blockDim.x) sc_sm[c] = scale[c];
    for (int c = lane; c < 2 * H; c += 32) acc_sm[c] = 0.f;
    __syncthreads();
  } else {
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int v = j * 32 + lane;
#pragma unroll
      for (int e = 0; e < kEpv; ++e) {
        sc[j * kEpv + e] = v < nvec ? scale[v * kEpv + e] : 0.f;
        acc_s[j * kEpv + e] = acc_b[j * kEpv + e] = 0.f;
      }
    }
  }
  auto scale_at = [&](int j, int e) {
    if constexpr (kWide) {
      return sc_sm[(j * 32 + lane) * kEpv + e];
    } else {
      return sc[j * kEpv + e];
    }
  };
  // The ring: stage t holds one row of s, dy (and gs).
  auto issue = [&](int row, int t) {
    if (row < rows) {
      const long long base = static_cast<long long>(row) * H;
      unsigned char* st = ring + static_cast<size_t>(t) * kArr * row_bytes;
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const int v = j * 32 + lane;
        if (v < nvec) {
          tc::cp_async16(st + v * 16, s + base + v * kEpv, true);
          tc::cp_async16(st + row_bytes + v * 16, dy + base + v * kEpv, true);
          if constexpr (kGs)
            tc::cp_async16(st + 2 * row_bytes + v * 16, gs + base + v * kEpv,
                           true);
        }
      }
    }
    tc::cp_async_commit();
  };
  auto read_stage = [&](P (&dst)[kNv], int t, int a) {
    const unsigned char* st =
        ring + (static_cast<size_t>(t) * kArr + a) * row_bytes;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int v = j * 32 + lane;
      if (v < nvec) {
        dst[j] = *reinterpret_cast<const P*>(st + v * 16);
      } else {
#pragma unroll
        for (int e = 0; e < kEpv; ++e) dst[j].e[e] = from_f32<T>(0.f);
      }
    }
  };

  constexpr bool kReload = kStages == 0;
  const int stride = gridDim.x * kLnBwdWarps;
  int r = blockIdx.x * kLnBwdWarps + warp;
  P cs[kReload ? 1 : kNv], cd[kReload ? 1 : kNv];
  if constexpr (kRing) {
#pragma unroll
    for (int t = 0; t + 1 < kStages; ++t) issue(r + t * stride, t);
  } else if constexpr (!kReload) {
    if (r < rows) {
      load_row<T, kNv, kEpv>(cs, s, static_cast<long long>(r) * H, lane,
                             nvec);
      load_row<T, kNv, kEpv>(cd, dy, static_cast<long long>(r) * H, lane,
                             nvec);
    }
  }
  for (int k = 0; r < rows; r += stride, ++k) {
    const long long base = static_cast<long long>(r) * H;
    const long long nbase = base + static_cast<long long>(stride) * H;
    const bool more = r + stride < rows;
    P ns[kStages == 1 ? kNv : 1], nd[kStages == 1 ? kNv : 1];
    P cg[kGs && !kReload ? kNv : 1];
    if constexpr (kRing) {
      // Refill the stage the previous row was read from, then wait for
      // this row's.
      issue(r + (kStages - 1) * stride, (k + kStages - 1) % kStages);
      tc::cp_async_wait<kStages - 1>();
      const int t = k % kStages;
      read_stage(cs, t, 0);
      read_stage(cd, t, 1);
      if constexpr (kGs) read_stage(cg, t, 2);
    } else if constexpr (kStages == 1) {
      if (more) {
        load_row<T, kNv, kEpv>(ns, s, nbase, lane, nvec);
        load_row<T, kNv, kEpv>(nd, dy, nbase, lane, nvec);
      }
      if constexpr (kGs) load_row<T, kNv, kEpv>(cg, gs, base, lane, nvec);
    }
    // The lane's vector j of this row's s and dy (valid vectors only).
    auto s_pack = [&](int j) {
      if constexpr (kReload) {
        return load_pack<T, kEpv>(s + base + (j * 32 + lane) * kEpv);
      } else {
        return cs[j];
      }
    };
    auto d_pack = [&](int j) {
      if constexpr (kReload) {
        return load_pack<T, kEpv>(dy + base + (j * 32 + lane) * kEpv);
      } else {
        return cd[j];
      }
    };

    // Statistics as the forward computes them: the mean, then the
    // centred variance.
    const float mean =
        warp_sum(lane_sum<kNv, kEpv>(lane, nvec,
                                     [&](int j, float (&a)[kEpv]) {
                                       const P ps = s_pack(j);
#pragma unroll
                                       for (int e = 0; e < kEpv; ++e)
                                         a[e] = to_f32(ps.e[e]);
                                     })) /
        fH;
    const float var =
        warp_sum(lane_sum<kNv, kEpv>(lane, nvec,
                                     [&](int j, float (&a)[kEpv]) {
                                       const P ps = s_pack(j);
#pragma unroll
                                       for (int e = 0; e < kEpv; ++e) {
                                         const float c =
                                             to_f32(ps.e[e]) - mean;
                                         a[e] = c * c;
                                       }
                                     })) /
        fH;
    const float rstd = 1.f / sqrtf(var + eps);
    float p1, p2;
    lane_sum2<kNv, kEpv>(
        lane, nvec,
        [&](int j, float (&a)[kEpv], float (&b)[kEpv]) {
          const P ps = s_pack(j), pd = d_pack(j);
#pragma unroll
          for (int e = 0; e < kEpv; ++e) {
            const float xhat = (to_f32(ps.e[e]) - mean) * rstd;
            a[e] = to_f32(pd.e[e]) * scale_at(j, e);
            b[e] = a[e] * xhat;
          }
        },
        p1, p2);
    warp_sum2(p1, p2);
    const float m1 = p1 / fH;
    const float m2 = p2 / fH;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int v = j * 32 + lane;
      if (v < nvec) {
        const P ps = s_pack(j), pd = d_pack(j);
        P pg;
        if constexpr (kGs) {
          if constexpr (kReload) {
            pg = load_pack<T, kEpv>(gs + base + v * kEpv);
          } else {
            pg = cg[j];
          }
        }
        P o;
#pragma unroll
        for (int e = 0; e < kEpv; ++e) {
          const float dv = to_f32(pd.e[e]);
          const float xhat = (to_f32(ps.e[e]) - mean) * rstd;
          float g = (dv * scale_at(j, e) - m1 - xhat * m2) * rstd;
          if constexpr (kGs) g += to_f32(pg.e[e]);
          o.e[e] = from_f32<T>(g);
          if constexpr (kWide) {
            acc_sm[v * kEpv + e] += dv * xhat;
            acc_sm[H + v * kEpv + e] += dv;
          } else {
            acc_s[j * kEpv + e] += dv * xhat;
            acc_b[j * kEpv + e] += dv;
          }
        }
        store_pack<T, kEpv>(dx + base + v * kEpv, o);
      }
    }
    if constexpr (kStages == 1) {
      if (more) {
#pragma unroll
        for (int j = 0; j < kNv; ++j) {
          cs[j] = ns[j];
          cd[j] = nd[j];
        }
      }
    }
  }
  if constexpr (kRing) tc::cp_async_wait<0>();

  // The block's partial row [2][H] of part [2][gridDim.x][H]: its warps'
  // fp32 sums added as a tree in warp order, in fp64, so that the sum
  // over the rows rounds about once, not once a warp and a block.
  if constexpr (!kWide) {
    __syncthreads();  // every warp is done with its ring
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int v = j * 32 + lane;
      if (v < nvec) {
#pragma unroll
        for (int e = 0; e < kEpv; ++e) {
          acc_sm[v * kEpv + e] = acc_s[j * kEpv + e];
          acc_sm[H + v * kEpv + e] = acc_b[j * kEpv + e];
        }
      }
    }
  }
  __syncthreads();
  const long long pbase = static_cast<long long>(blockIdx.x) * H;
  const long long half = static_cast<long long>(gridDim.x) * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    double ds[kLnBwdWarps], db[kLnBwdWarps];
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) {
      ds[w] = slots[w * 2 * H + c];
      db[w] = slots[w * 2 * H + H + c];
    }
    part[pbase + c] = tree_sum(ds);
    part[half + pbase + c] = tree_sum(db);
  }
}

// The second pass of K3b and K4b: out[i] for i = a*H + c (a < n / H;
// K3b: a = 0 dscale, 1 dbias) is the sum over blocks b of part[a][b][c],
// in fp64 and a fixed order, rounded once to fp32. A block takes 32
// consecutive i; its warp w sums the blocks b = w, w + 8, ... in order,
// and the eight warps' sums add as a tree. `red`: [kColsumWarps][32]
// doubles of shared memory.
constexpr int kColsumWarps = 8;
template <typename F>
__device__ __forceinline__ void colsum(const F* __restrict__ part,
                                       float* __restrict__ out, int blocks,
                                       int H, int n, double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  double acc = 0.0;
  if (i < n) {
    const int a = i / H;
    const F* p = part + static_cast<long long>(a) * blocks * H + (i - a * H);
    for (int b = warp; b < blocks; b += kColsumWarps)
      acc += static_cast<double>(p[static_cast<long long>(b) * H]);
  }
  red[warp * 32 + lane] = acc;
  __syncthreads();
  if (warp == 0 && i < n) {
    double v[kColsumWarps];
#pragma unroll
    for (int w = 0; w < kColsumWarps; ++w) v[w] = red[w * 32 + lane];
    out[i] = static_cast<float>(tree_sum(v));
  }
}

__global__ void __launch_bounds__(32 * kColsumWarps)
ln_bwd_colsum_kernel(const double* __restrict__ part, float* __restrict__ out,
                     int blocks, int H) {
  extern __shared__ double colsum_red[];
  colsum(part, out, blocks, H, 2 * H, colsum_red);
}

// K4f. Thread x of block (bx, by) owns column vector bx*blockDim.x + x
// (kEpv columns) of rows [by*rows_per_block, +rows_per_block).
template <typename T, int kEpv, bool kExact>
__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(const T* __restrict__ y, const float* __restrict__ b,
                 T* __restrict__ out, int rows, int F, int rows_per_block) {
  using P = Pack<T, kEpv>;
  const int nvec = F / kEpv;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  float bc[kEpv];
#pragma unroll
  for (int e = 0; e < kEpv; ++e) bc[e] = b[v * kEpv + e];
  const long long pitch = F;
  const T* yp = y + v * kEpv;
  T* op = out + v * kEpv;
  int r = r0;
  for (; r + kGeluUnroll <= r1; r += kGeluUnroll) {
    P in[kGeluUnroll];
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u)
      in[u] = load_pack<T, kEpv>(yp + (r + u) * pitch);
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u) {
      P o;
#pragma unroll
      for (int e = 0; e < kEpv; ++e)
        o.e[e] = from_f32<T>(gelu_f32<kExact>(gelu_input(in[u].e[e], bc[e])));
      store_pack<T, kEpv>(op + (r + u) * pitch, o);
    }
  }
  for (; r < r1; ++r) {
    const P in = load_pack<T, kEpv>(yp + r * pitch);
    P o;
#pragma unroll
    for (int e = 0; e < kEpv; ++e)
      o.e[e] = from_f32<T>(gelu_f32<kExact>(gelu_input(in.e[e], bc[e])));
    store_pack<T, kEpv>(op + r * pitch, o);
  }
}

// K4b. Thread (x, y) of block (bx, by), a block of blockDim.x x
// kGeluBwdSplit threads, owns column vector bx*blockDim.x + x (kEpv
// columns) of rows [r0 + y*rows_per_thread, +rows_per_thread), r0 =
// by*rows_per_thread*kGeluBwdSplit: dz for each, and the sum of its dz
// (unrounded, fp32, row order). The block adds its kGeluBwdSplit sums in
// y order into the partial dbias row part[by][column]. Dynamic shared
// memory: [kGeluBwdSplit][blockDim.x][kEpv] floats.
// One block an SM in the launch bounds: without it ptxas caps the main
// instances at 128 registers (two blocks an SM) and spills, which read
// slower on an H100 than one block at up to 255 (0.0625 against 0.0598
// ms, the tanh form at 8192 x 3072).
template <typename T, int kEpv, bool kExact>
__global__ void __launch_bounds__(kGeluThreads * kGeluBwdSplit, 1)
bias_gelu_bwd_kernel(const T* __restrict__ y, const float* __restrict__ b,
                     const T* __restrict__ g, T* __restrict__ dz_out,
                     float* __restrict__ part, int rows, int F,
                     int rows_per_thread) {
  using P = Pack<T, kEpv>;
  constexpr int kU = kGeluBwdUnroll;
  extern __shared__ float4 smem4[];
  const int nvec = F / kEpv;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = v < nvec;
  const int r0 =
      (blockIdx.y * kGeluBwdSplit + threadIdx.y) * rows_per_thread;
  const int r1 = live ? min(rows, r0 + rows_per_thread) : r0;
  float bc[kEpv], acc[kEpv];
#pragma unroll
  for (int e = 0; e < kEpv; ++e) {
    bc[e] = live ? b[v * kEpv + e] : 0.f;
    acc[e] = 0.f;
  }
  const long long pitch = F;
  const T* yp = y + v * kEpv;
  const T* gp = g + v * kEpv;
  T* dp = dz_out + v * kEpv;
  // dz of one row's vector; the 16-bit types convert in pairs (y and g
  // widened, z = round(y + b), the rounded dz), each pair one register.
  auto row = [&](const P& py, const P& pg, long long off) {
    P o;
    if constexpr (sizeof(T) == 2 && kEpv % 2 == 0) {
      uint32_t wy[kEpv / 2], wg[kEpv / 2], wo[kEpv / 2];
      memcpy(wy, &py, sizeof(P));
      memcpy(wg, &pg, sizeof(P));
#pragma unroll
      for (int q = 0; q < kEpv / 2; ++q) {
        float y0, y1, z0, z1, g0, g1;
        unpack_pair<T>(wy[q], y0, y1);
        unpack_pair<T>(pack_pair<T>(y0 + bc[2 * q], y1 + bc[2 * q + 1]), z0,
                       z1);
        unpack_pair<T>(wg[q], g0, g1);
        const float d0 = g0 * dgelu_f32<kExact>(z0);
        const float d1 = g1 * dgelu_f32<kExact>(z1);
        wo[q] = pack_pair<T>(d0, d1);
        acc[2 * q] += d0;
        acc[2 * q + 1] += d1;
      }
      memcpy(&o, wo, sizeof(P));
    } else {
#pragma unroll
      for (int e = 0; e < kEpv; ++e) {
        const float dz =
            to_f32(pg.e[e]) * dgelu_f32<kExact>(gelu_input(py.e[e], bc[e]));
        o.e[e] = from_f32<T>(dz);
        acc[e] += dz;
      }
    }
    store_pack<T, kEpv>(dp + off, o);
  };
  // Batches of kU rows: the next batch loads while this one computes.
  const int batches = (r1 - r0) / kU;
  P cy[kU], cg[kU];
  auto load = [&](P(&dy)[kU], P(&dg)[kU], int rb) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      dy[u] = load_pack<T, kEpv>(yp + (rb + u) * pitch);
      dg[u] = load_pack<T, kEpv>(gp + (rb + u) * pitch);
    }
  };
  if (batches > 0) load(cy, cg, r0);
  for (int k = 0; k < batches; ++k) {
    const int rb = r0 + k * kU;
    P ny[kU], ng[kU];
    if (k + 1 < batches) load(ny, ng, rb + kU);
#pragma unroll
    for (int u = 0; u < kU; ++u) row(cy[u], cg[u], (rb + u) * pitch);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      cy[u] = ny[u];
      cg[u] = ng[u];
    }
  }
  for (int r = r0 + batches * kU; r < r1; ++r)
    row(load_pack<T, kEpv>(yp + r * pitch), load_pack<T, kEpv>(gp + r * pitch),
        r * pitch);
  if constexpr (kGeluBwdSplit > 1) {
    float* red = reinterpret_cast<float*>(smem4);
    float* mine = red + (threadIdx.y * blockDim.x + threadIdx.x) * kEpv;
#pragma unroll
    for (int e = 0; e < kEpv; ++e) mine[e] = acc[e];
    __syncthreads();
    if (threadIdx.y != 0) return;
#pragma unroll
    for (int e = 0; e < kEpv; ++e) acc[e] = 0.f;
    for (int s = 0; s < kGeluBwdSplit; ++s) {
      const float* theirs = red + (s * blockDim.x + threadIdx.x) * kEpv;
#pragma unroll
      for (int e = 0; e < kEpv; ++e) acc[e] += theirs[e];
    }
  }
  if (!live) return;
  float* pp = part + static_cast<long long>(blockIdx.y) * F + v * kEpv;
#pragma unroll
  for (int e = 0; e < kEpv; ++e) pp[e] = acc[e];
}

__global__ void __launch_bounds__(32 * kColsumWarps)
bias_gelu_bwd_colsum_kernel(const float* __restrict__ part,
                            float* __restrict__ out, int blocks, int F) {
  extern __shared__ double colsum_red[];
  colsum(part, out, blocks, F, F, colsum_red);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Arguments of one K3f launch.
struct LnFwdArgs {
  const void *x, *d;
  const float *scale, *bias;
  void *s, *y;
  int rows, H;
  float eps;
  cudaStream_t st;
};

template <typename T, bool kResid, int kNv, int kEpv, bool kWide>
cudaError_t launch_ln_inst(const LnFwdArgs& a) {
  constexpr int kStages = ln_fwd_stages<T, kEpv, kWide>();
  constexpr int kBlocksPerSm = ln_fwd_min_blocks<kNv, kEpv, kWide>();
  // A warp a row over at most kBlocksPerSm blocks for each of an H100's
  // 132 SMs (fixed here, never queried): kLnFwdWarps warps a block, or
  // fewer where the rows are too few to give every block its warps (a
  // decode step's 8 rows run as 8 blocks of one warp).
  const int cap = 132 * kBlocksPerSm;
  const int need = (a.rows + cap - 1) / cap;
  const int warps = need < kLnFwdWarps ? need : kLnFwdWarps;
  const int want = (a.rows + warps - 1) / warps;
  const int blocks = want < cap ? want : cap;
  const size_t smem = kStages >= 2 ? static_cast<size_t>(warps) * kStages *
                                         (kResid ? 2 : 1) *
                                         static_cast<size_t>(a.H) *
                                         sizeof(T)
                                   : 0;
  auto kern = ln_fwd_kernel<T, kResid, kNv, kEpv, kWide>;
  // The largest dynamic shared memory this instance was opened for.
  static size_t opened = kMaxLnSmem;
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opened = smem;
  }
  kern<<<blocks, 32 * warps, smem, a.st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.d), a.scale,
      a.bias, static_cast<T*>(a.s), static_cast<T*>(a.y), a.rows, a.H,
      a.eps);
  return cudaGetLastError();
}

// The instance for H: 16-byte vectors where H is a multiple of the
// vector width and every row pointer is 16-byte aligned, else width 1;
// the fewest vectors a lane that cover the row. Rows past 32 bytes a
// lane of fp32 (H 512; the width-1 instance 512 too) or 64 of 16-bit
// values (H 1024) are wide: three passes over device memory.
template <typename T, bool kResid>
cudaError_t launch_ln(const LnFwdArgs& a) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.H % kVec == 0 && aligned16(a.x) && aligned16(a.y) &&
                   (!kResid || (aligned16(a.d) && aligned16(a.s)));
  if (vec) {
    const int nv = (a.H / kVec + 31) / 32;
    if constexpr (kVec == 8) {
      if (nv <= 1) return launch_ln_inst<T, kResid, 1, 8, false>(a);
      if (nv <= 2) return launch_ln_inst<T, kResid, 2, 8, false>(a);
      if (nv <= 3) return launch_ln_inst<T, kResid, 3, 8, false>(a);
      if (nv <= 4) return launch_ln_inst<T, kResid, 4, 8, false>(a);
      return launch_ln_inst<T, kResid, 1, 8, true>(a);
    } else {
      if (nv <= 1) return launch_ln_inst<T, kResid, 1, 4, false>(a);
      if (nv <= 2) return launch_ln_inst<T, kResid, 2, 4, false>(a);
      if (nv <= 4) return launch_ln_inst<T, kResid, 4, 4, false>(a);
      return launch_ln_inst<T, kResid, 1, 4, true>(a);
    }
  }
  const int nv = (a.H + 31) / 32;
  if (nv <= 8) return launch_ln_inst<T, kResid, 8, 1, false>(a);
  if (nv <= 16) return launch_ln_inst<T, kResid, 16, 1, false>(a);
  return launch_ln_inst<T, kResid, 1, 1, true>(a);
}

template <typename T>
cudaError_t launch_ln(const LnFwdArgs& a) {
  return a.d != nullptr ? launch_ln<T, true>(a) : launch_ln<T, false>(a);
}

// Arguments of one K3b launch.
struct LnBwdArgs {
  const void *s, *dy, *gs;
  const float* scale;
  void* dx;
  double* part;
  float* out;
  int rows, H, blocks;
  float eps;
  cudaStream_t st;
};

template <typename T, bool kGs, int kNv, int kEpv, bool kWide>
cudaError_t launch_ln_bwd_inst(const LnBwdArgs& a) {
  constexpr int kStages = ln_bwd_stages<T, kEpv, kWide>();
  const size_t H = static_cast<size_t>(a.H);
  const size_t ring = kStages >= 2 ? static_cast<size_t>(kLnBwdWarps) *
                                         kStages * (kGs ? 3 : 2) * H *
                                         sizeof(T)
                                   : 0;
  const size_t slots = static_cast<size_t>(kLnBwdWarps) * 2 * H * 4;
  const size_t smem = kWide ? H * 4 + slots : (ring > slots ? ring : slots);
  auto kern = ln_bwd_kernel<T, kGs, kNv, kEpv, kWide>;
  // The largest dynamic shared memory this instance was opened for.
  static size_t opened = kMaxLnSmem;
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opened = smem;
  }
  kern<<<a.blocks, kLnBwdThreads, smem, a.st>>>(
      static_cast<const T*>(a.s), a.scale, static_cast<const T*>(a.dy),
      static_cast<const T*>(a.gs), static_cast<T*>(a.dx), a.part, a.rows,
      a.H, a.eps);
  ln_bwd_colsum_kernel<<<(2 * a.H + 31) / 32, 32 * kColsumWarps,
                         kColsumWarps * 32 * sizeof(double), a.st>>>(
      a.part, a.out, a.blocks, a.H);
  return cudaGetLastError();
}

// The instance for H: 16-byte vectors where H is a multiple of the
// vector width and every row pointer is 16-byte aligned, else width 1;
// the fewest vectors a lane that cover the row. Rows past 32 bytes a
// lane of fp32 (H 512; the width-1 instance 512 too) or 64 of 16-bit
// values (H 1024) are wide: no prefetch, the scale and sums in shared
// memory.
template <typename T, bool kGs>
cudaError_t launch_ln_bwd(const LnBwdArgs& a) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.H % kVec == 0 && aligned16(a.s) && aligned16(a.dy) &&
                   aligned16(a.dx) && (a.gs == nullptr || aligned16(a.gs));
  if (vec) {
    const int nv = (a.H / kVec + 31) / 32;
    if constexpr (kVec == 8) {
      if (nv <= 1) return launch_ln_bwd_inst<T, kGs, 1, 8, false>(a);
      if (nv <= 2) return launch_ln_bwd_inst<T, kGs, 2, 8, false>(a);
      if (nv <= 3) return launch_ln_bwd_inst<T, kGs, 3, 8, false>(a);
      if (nv <= 4) return launch_ln_bwd_inst<T, kGs, 4, 8, false>(a);
      return launch_ln_bwd_inst<T, kGs, 8, 8, true>(a);
    } else {
      if (nv <= 2) return launch_ln_bwd_inst<T, kGs, 2, 4, false>(a);
      if (nv <= 4) return launch_ln_bwd_inst<T, kGs, 4, 4, false>(a);
      if (nv <= 8) return launch_ln_bwd_inst<T, kGs, 8, 4, true>(a);
      return launch_ln_bwd_inst<T, kGs, 16, 4, true>(a);
    }
  }
  const int nv = (a.H + 31) / 32;
  if (nv <= 8) return launch_ln_bwd_inst<T, kGs, 8, 1, false>(a);
  if (nv <= 16) return launch_ln_bwd_inst<T, kGs, 16, 1, false>(a);
  return launch_ln_bwd_inst<T, kGs, 64, 1, true>(a);
}

template <typename T>
cudaError_t launch_ln_bwd(const LnBwdArgs& a) {
  return a.gs != nullptr ? launch_ln_bwd<T, true>(a)
                         : launch_ln_bwd<T, false>(a);
}

template <typename T, int kEpv, bool kExact>
void launch_gelu_inst(const void* y, const float* b, void* out, int rows,
                      int F, cudaStream_t st) {
  const int nvec = F / kEpv;
  // Runs of kGeluRows rows on the training path's thousands of rows,
  // runs of kGeluUnroll on a serving step's few rows (more blocks), and
  // longer runs where grid.y would pass its 65535.
  int per = rows >= 2048 ? kGeluRows : kGeluUnroll;
  if ((rows + per - 1) / per > 65535) per = (rows + 65534) / 65535;
  const int threads = nvec < kGeluThreads ? (nvec + 31) / 32 * 32
                                          : kGeluThreads;
  dim3 grid((nvec + threads - 1) / threads, (rows + per - 1) / per);
  bias_gelu_kernel<T, kEpv, kExact><<<grid, threads, 0, st>>>(
      static_cast<const T*>(y), b, static_cast<T*>(out), rows, F, per);
}

template <typename T, bool kExact>
void launch_gelu(const void* y, const float* b, void* out, int rows, int F,
                 cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (F % kVec == 0 && aligned16(y) && aligned16(out)) {
    launch_gelu_inst<T, kVec, kExact>(y, b, out, rows, F, st);
  } else {
    launch_gelu_inst<T, 1, kExact>(y, b, out, rows, F, st);
  }
}

template <typename T>
void launch_gelu(const void* y, const float* b, void* out, int rows, int F,
                 int exact, cudaStream_t st) {
  if (exact) {
    launch_gelu<T, true>(y, b, out, rows, F, st);
  } else {
    launch_gelu<T, false>(y, b, out, rows, F, st);
  }
}

// Rows a K4b thread walks for `rows` rows: kGeluBwdRows, or more where
// grid.y would pass its 65535.
int gelu_bwd_rows_per_thread(int rows) {
  constexpr int kMaxBlockRows = 65535 * kGeluBwdSplit;
  const int per = (rows + kMaxBlockRows - 1) / kMaxBlockRows;
  return per > kGeluBwdRows ? per : kGeluBwdRows;
}

// Arguments of one K4b launch.
struct GeluBwdArgs {
  const void *y, *g;
  const float* b;
  void* dz;
  float *part, *dbias;
  int rows, F;
  cudaStream_t st;
};

template <typename T, int kEpv, bool kExact>
void launch_gelu_bwd_inst(const GeluBwdArgs& a) {
  const int nvec = a.F / kEpv;
  const int per = gelu_bwd_rows_per_thread(a.rows);
  const int tx = nvec < kGeluThreads ? (nvec + 31) / 32 * 32 : kGeluThreads;
  const dim3 threads(tx, kGeluBwdSplit);
  const dim3 grid((nvec + tx - 1) / tx,
                  (a.rows + per * kGeluBwdSplit - 1) / (per * kGeluBwdSplit));
  const size_t smem =
      kGeluBwdSplit > 1 ? sizeof(float) * kGeluBwdSplit * tx * kEpv : 0;
  bias_gelu_bwd_kernel<T, kEpv, kExact><<<grid, threads, smem, a.st>>>(
      static_cast<const T*>(a.y), a.b, static_cast<const T*>(a.g),
      static_cast<T*>(a.dz), a.part, a.rows, a.F, per);
}

template <typename T, bool kExact>
void launch_gelu_bwd(const GeluBwdArgs& a) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.F % kVec == 0 && aligned16(a.y) && aligned16(a.g) &&
      aligned16(a.dz)) {
    launch_gelu_bwd_inst<T, kVec, kExact>(a);
  } else {
    launch_gelu_bwd_inst<T, 1, kExact>(a);
  }
}

template <typename T>
void launch_gelu_bwd(const GeluBwdArgs& a, int exact) {
  if (exact) {
    launch_gelu_bwd<T, true>(a);
  } else {
    launch_gelu_bwd<T, false>(a);
  }
}

}  // namespace

// x, d (nullable), s (nullable iff d is), y: [rows, H] contiguous in
// `dtype`; scale, bias: [H] fp32.
extern "C" int dstt_layer_norm(const void* x, const void* d,
                               const void* scale, const void* bias,
                               void* s, void* y, int rows, int H, float eps,
                               int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0) return cudaErrorInvalidValue;
  if ((d == nullptr) != (s == nullptr)) return cudaErrorInvalidValue;
  const LnFwdArgs a{x, d, static_cast<const float*>(scale),
                    static_cast<const float*>(bias), s, y, rows, H, eps,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_ln<float>(a);
  if (dtype == kBFloat16) return launch_ln<__nv_bfloat16>(a);
  if (dtype == kFloat16) return launch_ln<__half>(a);
  return cudaErrorInvalidValue;
}

// Number of blocks (= partial dscale/dbias rows) that
// dstt_layer_norm_bwd launches for `rows` rows: a warp a row up to
// kLnBwdMaxBlocks blocks.
extern "C" int dstt_layer_norm_bwd_blocks(int rows) {
  const int blocks = (rows + kLnBwdWarps - 1) / kLnBwdWarps;
  return blocks < kLnBwdMaxBlocks ? blocks : kLnBwdMaxBlocks;
}

// s, dy, gs (nullable), dx: [rows, H] contiguous in `dtype`, rows >= 1;
// scale: [H] fp32; part: [2, dstt_layer_norm_bwd_blocks(rows), H] fp64
// scratch (the blocks' partial dscale and dbias rows); out: [2, H] fp32,
// dscale then dbias. Two launches: the rows, then the partials' sum.
extern "C" int dstt_layer_norm_bwd(const void* s, const void* scale,
                                   const void* dy, const void* gs, void* dx,
                                   void* part, void* out, int rows, int H,
                                   float eps, int dtype, void* stream) {
  if (rows <= 0 || H <= 0 || H > kLnBwdMaxH) return cudaErrorInvalidValue;
  const LnBwdArgs a{s, dy, gs, static_cast<const float*>(scale), dx,
                    static_cast<double*>(part), static_cast<float*>(out),
                    rows, H, dstt_layer_norm_bwd_blocks(rows), eps,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_ln_bwd<float>(a);
  if (dtype == kBFloat16) return launch_ln_bwd<__nv_bfloat16>(a);
  if (dtype == kFloat16) return launch_ln_bwd<__half>(a);
  return cudaErrorInvalidValue;
}

// y, out: [n / F, F] contiguous in `dtype`; b: [F] fp32; exact: 1 for
// the erf form, 0 for the tanh form.
extern "C" int dstt_bias_gelu(const void* y, const void* b, void* out,
                              long long n, int F, int exact, int dtype,
                              void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F <= 0 || n % F != 0 || n / F > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int rows = static_cast<int>(n / F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (dtype == kFloat32) {
    launch_gelu<float>(y, bf, out, rows, F, exact, st);
  } else if (dtype == kBFloat16) {
    launch_gelu<__nv_bfloat16>(y, bf, out, rows, F, exact, st);
  } else if (dtype == kFloat16) {
    launch_gelu<__half>(y, bf, out, rows, F, exact, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Number of row runs (= rows of the dbias partials) that
// dstt_bias_gelu_bwd launches for `rows` rows.
extern "C" int dstt_bias_gelu_bwd_splits(int rows) {
  if (rows <= 0) return 0;
  const int per = gelu_bwd_rows_per_thread(rows) * kGeluBwdSplit;
  return (rows + per - 1) / per;
}

// y, g, dz: [rows, F] contiguous in `dtype`; b: [F] fp32; part:
// [dstt_bias_gelu_bwd_splits(rows), F] fp32 scratch (the runs' partial
// dbias rows); dbias: [F] fp32 output; exact: 1 for the erf form's
// derivative, 0 for the tanh form's. Two launches: the rows, then the
// partials' sum (zeros for no rows).
extern "C" int dstt_bias_gelu_bwd(const void* y, const void* b,
                                  const void* g, void* dz, void* part,
                                  void* dbias, int rows, int F, int exact,
                                  int dtype, void* stream) {
  if (rows < 0 || F <= 0) return cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16 && dtype != kFloat16)
    return cudaErrorInvalidValue;
  const GeluBwdArgs a{y, g, static_cast<const float*>(b), dz,
                      static_cast<float*>(part), static_cast<float*>(dbias),
                      rows, F, static_cast<cudaStream_t>(stream)};
  if (rows > 0) {
    if (dtype == kFloat32) {
      launch_gelu_bwd<float>(a, exact);
    } else if (dtype == kBFloat16) {
      launch_gelu_bwd<__nv_bfloat16>(a, exact);
    } else {
      launch_gelu_bwd<__half>(a, exact);
    }
  }
  bias_gelu_bwd_colsum_kernel<<<(F + 31) / 32, 32 * kColsumWarps,
                                kColsumWarps * 32 * sizeof(double), a.st>>>(
      a.part, a.dbias, dstt_bias_gelu_bwd_splits(rows), F);
  return cudaGetLastError();
}
