// The fused one-pass Adam step: the grad sum-of-squares partials (the
// global norm, which doubles as the fp16 overflow vote) and the single
// pass over g, p, m, v that applies the update.
//
// Replaces (TPU, Pallas):
//   deepspeed_tpu/ops/fused_update.py::_sqnorm_kernel     (K5)
//   deepspeed_tpu/ops/fused_update.py::_fused_adam_kernel (K6)
//
// Bound on an H100: memory bytes. K5 reads the fp32 grads once (4 B per
// element). K6 reads g, p, m, v and writes p, m, v, plus the
// compute-dtype copy of p when the engine keeps one: 28 B per element
// for fp32 masters, 30 B with a bf16/fp16 cast copy, 22 B master-free
// (bf16 p). About 20 fp32 operations per element, far below the rate.
//
// Design. The TPU kernels walk a [rows, 1024] view of the V=8-interleaved
// group buffer in (rows_block, 1024) tiles; that layout exists for ZeRO
// sharding over dp. On one card each dtype group is one contiguous flat
// buffer and both kernels are grid-stride loops over it.
// - K5: each thread sums squares of its elements in fp32 (float4 loads),
//   the block reduces, and block b writes partial[b]. The grid is fixed
//   by n, so the partials and their sum (one torch.sum outside the
//   kernel, as the TPU path sums its per-chunk partials) do not depend
//   on scheduling. inf/nan in any grad make the sum non-finite.
// - K6: one thread per element. The scalar row (neg_lr, bias
//   corrections, clip coefficient, 1/loss_scale, skip) and the seed row
//   are read from device memory, so the host never syncs to set them.
//   The arithmetic is written with __fmul_rn/__fadd_rn/__fdiv_rn/
//   __fsqrt_rn in the JAX kernel's (optax's) association order: nvcc may
//   not contract it into FMAs, so the kernel rounds exactly as the plain
//   PyTorch version does, op by op. The overflow skip is a select
//   against the old values already in registers. The bf16 stochastic
//   rounding adds 16 bits of murmur3-finalizer noise (of base + flat
//   index, xor seed) to the fp32 mantissa tail and truncates; inf/nan
//   pass through rounded to nearest.
#include <cstdint>

#include "common.cuh"

using namespace dstt;

namespace {

constexpr int kSqThreads = 256;
constexpr int kSqMaxBlocks = 132 * 8;
constexpr int kAdamThreads = 256;
constexpr int kAdamMaxBlocks = 132 * 16;

// Flag bits of dstt_fused_adam (ops/fused_update.py builds them).
constexpr int kCoupled = 1;    // L2 decay folded into the grad (Adam)
constexpr int kUseInv = 2;     // multiply g by 1/loss_scale
constexpr int kUseCoeff = 4;   // multiply g by the clip coefficient
constexpr int kOnePass = 8;    // overflow skip as an in-pass select
constexpr int kHasWd = 16;     // weight_decay != 0

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kSqThreads)
sqnorm_kernel(const float* __restrict__ g, long long n,
              float* __restrict__ partial) {
  __shared__ float red[32];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float acc = 0.f;
  for (long long i = tid; i < n4; i += stride) {
    const float4 v = g4[i];
    acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) acc += g[i] * g[i];
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

struct AdamConsts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

template <typename P, typename C, bool kCast, bool kSr>
__global__ void __launch_bounds__(kAdamThreads)
fused_adam_kernel(const float* __restrict__ g, P* __restrict__ p,
                  float* __restrict__ m, float* __restrict__ v,
                  C* __restrict__ cast_out, const float* __restrict__ scal,
                  const int* __restrict__ seed, long long n, AdamConsts k,
                  int flags) {
  const float neg_lr = scal[0], bc1 = scal[1], bc2 = scal[2];
  const float coeff = scal[3], inv = scal[4];
  const bool keep_old = (flags & kOnePass) && scal[5] > 0.f;
  const bool use_inv = flags & kUseInv, use_coeff = flags & kUseCoeff;
  const bool coupled_wd = (flags & kCoupled) && (flags & kHasWd);
  const bool decoupled_wd = !(flags & kCoupled) && (flags & kHasWd);
  const uint32_t sr_seed = static_cast<uint32_t>(seed[0]);
  const uint32_t sr_base = static_cast<uint32_t>(seed[1]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float gg = g[i];
    if (use_inv) gg = __fmul_rn(gg, inv);
    if (use_coeff) gg = __fmul_rn(gg, coeff);
    const float p32 = to_f32(p[i]);
    if (coupled_wd) gg = __fadd_rn(gg, __fmul_rn(k.wd, p32));
    const float mo = m[i], vo = v[i];
    float mn = __fadd_rn(__fmul_rn(k.one_minus_b1, gg), __fmul_rn(k.b1, mo));
    float vn = __fadd_rn(__fmul_rn(k.one_minus_b2, __fmul_rn(gg, gg)),
                         __fmul_rn(k.b2, vo));
    float u = __fdiv_rn(__fdiv_rn(mn, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), k.eps));
    if (decoupled_wd) u = __fadd_rn(u, __fmul_rn(k.wd, p32));
    float np = __fadd_rn(p32, __fmul_rn(u, neg_lr));
    if (keep_old) {
      np = p32;
      mn = mo;
      vn = vo;
    }
    m[i] = mn;
    v[i] = vn;
    if (kCast) cast_out[i] = from_f32<C>(np);
    if (kSr) {
      const uint32_t idx = sr_base + static_cast<uint32_t>(i);
      const uint32_t noise = hash_u32(idx ^ sr_seed) & 0xFFFFu;
      const uint32_t bits = (__float_as_uint(np) + noise) & 0xFFFF0000u;
      p[i] = from_f32<P>(isfinite(np) ? __uint_as_float(bits) : np);
    } else {
      p[i] = from_f32<P>(np);
    }
  }
}

template <typename P, typename C, bool kCast, bool kSr>
void launch_adam(const void* g, void* p, void* m, void* v, void* cast,
                 const void* scal, const void* seed, long long n,
                 const AdamConsts& k, int flags, cudaStream_t st) {
  long long blocks = (n + kAdamThreads - 1) / kAdamThreads;
  if (blocks > kAdamMaxBlocks) blocks = kAdamMaxBlocks;
  fused_adam_kernel<P, C, kCast, kSr>
      <<<static_cast<int>(blocks), kAdamThreads, 0, st>>>(
          static_cast<const float*>(g), static_cast<P*>(p),
          static_cast<float*>(m), static_cast<float*>(v),
          static_cast<C*>(cast), static_cast<const float*>(scal),
          static_cast<const int*>(seed), n, k, flags);
}

}  // namespace

// Number of blocks (= length of the partials) dstt_sqnorm launches.
extern "C" int dstt_sqnorm_blocks(long long n) {
  long long b = (n / 4 + kSqThreads - 1) / kSqThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kSqMaxBlocks ? b : kSqMaxBlocks);
}

// g: [n] fp32, 16-byte aligned; partial: [dstt_sqnorm_blocks(n)] fp32.
extern "C" int dstt_sqnorm(const void* g, long long n, void* partial,
                           void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(g) % 16 != 0) return cudaErrorInvalidValue;
  sqnorm_kernel<<<dstt_sqnorm_blocks(n), kSqThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), n, static_cast<float*>(partial));
  return cudaGetLastError();
}

// One fused Adam pass over a flat group, in place on p, m, v.
// g, m, v: [n] fp32; p: [n] in p_dtype (fp32, or bf16 master-free);
// cast (nullable): [n] in cast_dtype (bf16 or fp16), only with fp32 p;
// scalars: [8] fp32 device [neg_lr, bc1, bc2, coeff, inv, skip, 0, 0];
// seed: [2] int32 device [sr seed, base index]; sr needs bf16 p.
extern "C" int dstt_fused_adam(const void* g, void* p, void* m, void* v,
                               void* cast, const void* scalars,
                               const void* seed, long long n, int p_dtype,
                               int cast_dtype, int sr, int flags, float b1,
                               float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float wd,
                               void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamConsts k{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  if (p_dtype == kFloat32 && !sr) {
    if (cast == nullptr) {
      launch_adam<float, float, false, false>(g, p, m, v, nullptr, scalars,
                                              seed, n, k, flags, st);
    } else if (cast_dtype == kBFloat16) {
      launch_adam<float, __nv_bfloat16, true, false>(
          g, p, m, v, cast, scalars, seed, n, k, flags, st);
    } else if (cast_dtype == kFloat16) {
      launch_adam<float, __half, true, false>(g, p, m, v, cast, scalars, seed,
                                              n, k, flags, st);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (p_dtype == kBFloat16 && cast == nullptr) {
    if (sr) {
      launch_adam<__nv_bfloat16, float, false, true>(
          g, p, m, v, nullptr, scalars, seed, n, k, flags, st);
    } else {
      launch_adam<__nv_bfloat16, float, false, false>(
          g, p, m, v, nullptr, scalars, seed, n, k, flags, st);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
