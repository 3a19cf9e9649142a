// Host-resident SIMD Adam/AdamW for ZeRO-Offload: the port's copy of the
// JAX package's csrc/cpu_adam.cpp (same six entry points, same arithmetic,
// same build flags), compiled with the host's C++ compiler by
// ops/op_builder.py (build_host) into its own shared library and called
// through ctypes by ops/cpu_adam.py.
//
// This is a host kernel, not a port of a TPU kernel: it replaces nothing
// that reaches pl.pallas_call. The fp32 masters and both Adam moments live
// in host memory; the device keeps only the compute-dtype parameters.
//
// Bound. One step over n parameters with bf16 gradients and the bf16
// staging copy reads g (2 B), p, m, v (12 B) and writes p, m, v (12 B)
// and the copy (2 B): 28 B a parameter, a pure stream. On a host that is
// its memory bandwidth; the loop below does about 15 flops a parameter.
// ds_stream_adam_traffic moves the same bytes with no arithmetic, and
// ds_stream_read reads one span: the host's rate for the bound.
//
// Design. The hot loop is a restrict-qualified fused multiply-add chain
// under `#pragma omp parallel for simd`, which g++ vectorizes for the
// host's ISA (-march=native); -fno-math-errno and -fno-trapping-math let
// sqrtf vectorize. It is written once (adam_step below) for the four Adam
// entry points. The "_plus_copy" variants write the bf16 copy of the
// updated params (round to nearest even) in the same pass over memory, so
// the fp32 masters are never re-read for the cast. The "_bf16g" variants
// read bf16 gradients (the wire dtype of bf16 runs) and widen them
// inline: half the gradient traffic and no host cast pass.
//
// Team size. Adam is elementwise, so its bits do not depend on how many
// OpenMP threads run a call. The squared norms sum in numpy's order for
// a float64 `np.sum` (what the JAX module's numpy path computes): the
// span in blocks of 8192 elements, each block summed pairwise (eight
// accumulators over runs of at most 128, halves rounded down to a
// multiple of 8), the blocks' sums added in index order. The order is
// fixed by the span's length alone, so the bits depend neither on the
// team (threads take whole blocks) nor on the host's SIMD width; each
// square is stored before it is added, so no multiply-add contracts it.

#include <cstdint>
#include <cmath>
#include <vector>
#include <omp.h>

namespace {

// fp32 -> bf16 with round-to-nearest-even.
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  __builtin_memcpy(&x, &f, 4);
  uint32_t lsb = (x >> 16) & 1u;
  x += 0x7fffu + lsb;
  return (uint16_t)(x >> 16);
}

// bf16 -> f32 (exact widening).
inline float bf16_to_f32(uint16_t h) {
  uint32_t x = ((uint32_t)h) << 16;
  float f;
  __builtin_memcpy(&f, &x, 4);
  return f;
}

inline float widen(float g) { return g; }
inline float widen(uint16_t g) { return bf16_to_f32(g); }

// One Adam/AdamW step over a contiguous span (the entry points below);
// G is the gradient's type (fp32, or bf16 bits), kCopy writes the bf16
// copy of the updated params.
template <typename G, bool kCopy>
inline void adam_step(float* __restrict params, const G* __restrict grads,
                      float* __restrict exp_avg, float* __restrict exp_avg_sq,
                      uint16_t* __restrict params_bf16, int64_t n,
                      int32_t step, float lr, float beta1, float beta2,
                      float eps, float weight_decay, int32_t adamw_mode,
                      float grad_scale) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float step_size = lr / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float decay = weight_decay;

#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = widen(grads[i]) * grad_scale;
    float p = params[i];
    if (!adamw_mode && decay != 0.0f) g += decay * p;
    float m = exp_avg[i] * beta1 + g * omb1;
    float v = exp_avg_sq[i] * beta2 + g * g * omb2;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    // AdamW: decoupled decay applied directly to p (p -= lr * wd * p).
    float newp = p - step_size * (m / denom) -
                 (adamw_mode ? lr * decay * p : 0.0f);
    params[i] = newp;
    if (kCopy) params_bf16[i] = f32_to_bf16(newp);
  }
}

// numpy's block of a reduction (its ufunc buffer size) and the run that
// its pairwise sum adds with eight accumulators.
constexpr int64_t kNormBlock = 8192;
constexpr int64_t kPairwiseRun = 128;

// numpy's pairwise sum of sq[0..n) (pairwise_sum_DOUBLE).
inline double pairwise_sum(const double* sq, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += sq[i];
    return res;
  }
  if (n <= kPairwiseRun) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = sq[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += sq[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += sq[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(sq, n2) + pairwise_sum(sq + n2, n - n2);
}

// Squared L2 norm of a scaled gradient span: each element widened to
// fp64 and scaled there, squared, and summed in numpy's order (see
// "Team size" above).
template <typename G>
inline double norm_sq(const G* __restrict grads, int64_t n,
                      double grad_scale) {
  const int64_t blocks = (n + kNormBlock - 1) / kNormBlock;
  std::vector<double> partial(blocks, 0.0);
#pragma omp parallel
  {
    std::vector<double> sq(kNormBlock);
#pragma omp for schedule(static)
    for (int64_t b = 0; b < blocks; ++b) {
      const int64_t lo = b * kNormBlock;
      const int64_t len = n - lo < kNormBlock ? n - lo : kNormBlock;
      double* __restrict out = sq.data();
#pragma omp simd
      for (int64_t i = 0; i < len; ++i) {
        const double g = (double)widen(grads[lo + i]) * grad_scale;
        out[i] = g * g;
      }
      partial[b] = pairwise_sum(out, len);
    }
  }
  double acc = 0.0;
  for (int64_t b = 0; b < blocks; ++b) acc += partial[b];
  return acc;
}

}  // namespace

extern "C" {

// One Adam/AdamW step over a contiguous fp32 span.
//
//  params/grads/exp_avg/exp_avg_sq : length-n fp32 arrays (params, moments
//                                    updated in place)
//  step        : 1-based optimizer step (bias correction)
//  grad_scale  : multiplied into every gradient read — carries the
//                combined loss-scale inverse and clip coefficient so no
//                separate pass over the gradients is needed
//  adamw_mode  : 1 = decoupled weight decay (AdamW), 0 = coupled L2 folded
//                into the gradient (classic Adam)
void ds_adam_step(float* __restrict params,
                  const float* __restrict grads,
                  float* __restrict exp_avg,
                  float* __restrict exp_avg_sq,
                  int64_t n, int32_t step,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int32_t adamw_mode, float grad_scale) {
  adam_step<float, false>(params, grads, exp_avg, exp_avg_sq, nullptr, n,
                          step, lr, beta1, beta2, eps, weight_decay,
                          adamw_mode, grad_scale);
}

// Adam step fused with the bf16 staging copy of the updated params.
void ds_adam_step_plus_copy(float* __restrict params,
                            const float* __restrict grads,
                            float* __restrict exp_avg,
                            float* __restrict exp_avg_sq,
                            uint16_t* __restrict params_bf16,
                            int64_t n, int32_t step,
                            float lr, float beta1, float beta2, float eps,
                            float weight_decay, int32_t adamw_mode,
                            float grad_scale) {
  adam_step<float, true>(params, grads, exp_avg, exp_avg_sq, params_bf16,
                         n, step, lr, beta1, beta2, eps, weight_decay,
                         adamw_mode, grad_scale);
}

// Adam step consuming bf16 gradients directly, fused with the bf16
// staging copy like ds_adam_step_plus_copy.
void ds_adam_step_plus_copy_bf16g(float* __restrict params,
                                  const uint16_t* __restrict grads_bf16,
                                  float* __restrict exp_avg,
                                  float* __restrict exp_avg_sq,
                                  uint16_t* __restrict params_bf16,
                                  int64_t n, int32_t step,
                                  float lr, float beta1, float beta2,
                                  float eps, float weight_decay,
                                  int32_t adamw_mode, float grad_scale) {
  adam_step<uint16_t, true>(params, grads_bf16, exp_avg, exp_avg_sq,
                            params_bf16, n, step, lr, beta1, beta2, eps,
                            weight_decay, adamw_mode, grad_scale);
}

// Same, without the staging copy.
void ds_adam_step_bf16g(float* __restrict params,
                        const uint16_t* __restrict grads_bf16,
                        float* __restrict exp_avg,
                        float* __restrict exp_avg_sq,
                        int64_t n, int32_t step,
                        float lr, float beta1, float beta2, float eps,
                        float weight_decay, int32_t adamw_mode,
                        float grad_scale) {
  adam_step<uint16_t, false>(params, grads_bf16, exp_avg, exp_avg_sq,
                             nullptr, n, step, lr, beta1, beta2, eps,
                             weight_decay, adamw_mode, grad_scale);
}

// Squared L2 norm of a scaled bf16 gradient span (numpy's fp64 order).
double ds_grad_norm_sq_bf16(const uint16_t* __restrict grads_bf16, int64_t n,
                            double grad_scale) {
  return norm_sq(grads_bf16, n, grad_scale);
}

// Squared L2 norm of a scaled fp32 gradient span (the overflow vote and
// the clip coefficient of an offloaded step are decided on the host).
double ds_grad_norm_sq(const float* __restrict grads, int64_t n,
                       double grad_scale) {
  return norm_sq(grads, n, grad_scale);
}

// The calling thread's OpenMP team size for its next parallel regions,
// and the default team size.
void ds_omp_set_threads(int32_t n) { omp_set_num_threads(n); }

int32_t ds_omp_max_threads() { return (int32_t)omp_get_max_threads(); }

// Memory-rate probes for the Adam step's bound, on the calling thread's
// team: the bytes of ds_adam_step_plus_copy_bf16g (p, m, v read and
// written in place, bf16 grads read, the bf16 copy written) with an add
// in place of the arithmetic, and a sum of one fp32 span (reads only).
void ds_stream_adam_traffic(float* __restrict params,
                            const uint16_t* __restrict grads_bf16,
                            float* __restrict exp_avg,
                            float* __restrict exp_avg_sq,
                            uint16_t* __restrict params_bf16, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = bf16_to_f32(grads_bf16[i]);
    float p = params[i] + g;
    exp_avg[i] += g;
    exp_avg_sq[i] += g;
    params[i] = p;
    params_bf16[i] = f32_to_bf16(p);
  }
}

double ds_stream_read(const float* __restrict a, int64_t n) {
  // 64 fp32 accumulators a thread (independent SIMD add chains), so the
  // loop waits on memory and not on one chain's latency.
  const int64_t blocks = n / 64;
  double total = 0.0;
#pragma omp parallel reduction(+ : total)
  {
    float acc[64] = {0.0f};
#pragma omp for schedule(static)
    for (int64_t b = 0; b < blocks; ++b) {
#pragma omp simd
      for (int j = 0; j < 64; ++j) acc[j] += a[b * 64 + j];
    }
    for (int j = 0; j < 64; ++j) total += acc[j];
  }
  for (int64_t i = blocks * 64; i < n; ++i) total += a[i];
  return total;
}

}  // extern "C"
