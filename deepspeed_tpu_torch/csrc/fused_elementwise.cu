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
// The arithmetic is a few fp32 operations per element, far below the
// card's rate.
//
// Design. The TPU kernels lane-pad H to 128 and mask the pad columns;
// here a block owns a row, threads stride over its columns, and the
// ragged edge needs no padding.
// - LN forward: the row is staged once in shared memory as fp32 so the
//   two statistics passes (mean, then the centered variance, exactly as
//   the reference computes them) and the output pass read it from
//   shared memory instead of device memory. The residual sum is rounded
//   to the storage dtype BEFORE the statistics read it, which keeps `s`
//   bit-equal to the unfused `x + delta`.
// - LN backward: mean and rstd are recomputed from `s` in the block (two
//   passes, as the forward), never saved. Each thread keeps its own
//   columns of s and dy in registers (at most kLnBwdCols per thread, so
//   H <= 2048), dx = (dxhat - m1 - xhat*m2)*rstd (+ gs) is rounded once.
//   The TPU grid carries per-block dscale/dbias partials that are summed
//   outside the kernel; here a block walks rows blockIdx.x,
//   blockIdx.x + gridDim.x, ... and accumulates its columns' partial
//   sums in registers, in a fixed order, then writes one [H] partial
//   row: no atomics, so dscale/dbias do not depend on scheduling.
// - GELU rounds z = y + b to the storage dtype first, then evaluates the
//   tanh form (and its derivative) in fp32 with tanhf, no fast-math, as
//   the TPU kernels do. The backward gives each thread one column and a
//   run of rows: its loads are coalesced across the warp, and its dbias
//   partial is a register sum over its rows.
#include "common.cuh"

using namespace dstt;

namespace {

constexpr int kLnThreads = 256;
constexpr int kGeluThreads = 256;
constexpr int kMaxLnSmem = 48 * 1024;
constexpr int kLnBwdThreads = 256;
constexpr int kLnBwdCols = 8;                       // H <= 2048
constexpr int kLnBwdMaxBlocks = 132 * 4;
constexpr int kGeluBwdThreads = 256;
constexpr int kGeluBwdRowSplits = 128;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
// 3 * 0.044715 folded in double, as the reference's Python expression
// folds it before the fp32 multiply.
constexpr float kGelu3C = static_cast<float>(3.0 * 0.044715);

template <typename T, bool kResid>
__global__ void __launch_bounds__(kLnThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d,
              const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ s_out,
              T* __restrict__ y_out, int H, float eps) {
  extern __shared__ float smem[];
  float* row = smem;      // [H] the (residual-summed) row in fp32
  float* red = smem + H;  // [32] reduction scratch
  const long long base = static_cast<long long>(blockIdx.x) * H;

  float sum = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float v = to_f32(x[base + i]);
    if (kResid) {
      const T sv = from_f32<T>(v + to_f32(d[base + i]));
      s_out[base + i] = sv;
      v = to_f32(sv);
    }
    row[i] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / static_cast<float>(H);
  float sq = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float c = row[i] - mean;
    sq += c * c;
  }
  const float var = block_sum(sq, red) / static_cast<float>(H);
  const float rstd = 1.f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    y_out[base + i] = from_f32<T>((row[i] - mean) * rstd * scale[i] + bias[i]);
  }
}

template <typename T, bool kGs>
__global__ void __launch_bounds__(kLnBwdThreads)
ln_bwd_kernel(const T* __restrict__ s, const float* __restrict__ scale,
              const T* __restrict__ dy, const T* __restrict__ gs,
              T* __restrict__ dx, float* __restrict__ dscale_part,
              float* __restrict__ dbias_part, int rows, int H, float eps) {
  __shared__ float red[32];
  float acc_dsc[kLnBwdCols], acc_dbi[kLnBwdCols];
#pragma unroll
  for (int j = 0; j < kLnBwdCols; ++j) acc_dsc[j] = acc_dbi[j] = 0.f;

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long base = static_cast<long long>(r) * H;
    float sv[kLnBwdCols], dv[kLnBwdCols];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLnBwdCols; ++j) {
      const int c = threadIdx.x + j * kLnBwdThreads;
      sv[j] = dv[j] = 0.f;
      if (c < H) {
        sv[j] = to_f32(s[base + c]);
        dv[j] = to_f32(dy[base + c]);
        sum += sv[j];
      }
    }
    // Statistics exactly as the forward computes them.
    const float mean = block_sum(sum, red) / static_cast<float>(H);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kLnBwdCols; ++j) {
      if (threadIdx.x + j * kLnBwdThreads < H) {
        const float c = sv[j] - mean;
        sq += c * c;
      }
    }
    const float var = block_sum(sq, red) / static_cast<float>(H);
    const float rstd = 1.f / sqrtf(var + eps);
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < kLnBwdCols; ++j) {
      const int c = threadIdx.x + j * kLnBwdThreads;
      if (c < H) {
        const float xhat = (sv[j] - mean) * rstd;
        const float dxhat = dv[j] * scale[c];
        p1 += dxhat;
        p2 += dxhat * xhat;
      }
    }
    const float m1 = block_sum(p1, red) / static_cast<float>(H);
    const float m2 = block_sum(p2, red) / static_cast<float>(H);
#pragma unroll
    for (int j = 0; j < kLnBwdCols; ++j) {
      const int c = threadIdx.x + j * kLnBwdThreads;
      if (c < H) {
        const float xhat = (sv[j] - mean) * rstd;
        const float dxhat = dv[j] * scale[c];
        float g = (dxhat - m1 - xhat * m2) * rstd;
        if (kGs) g += to_f32(gs[base + c]);
        dx[base + c] = from_f32<T>(g);
        acc_dsc[j] += dv[j] * xhat;
        acc_dbi[j] += dv[j];
      }
    }
  }
  const long long pbase = static_cast<long long>(blockIdx.x) * H;
#pragma unroll
  for (int j = 0; j < kLnBwdCols; ++j) {
    const int c = threadIdx.x + j * kLnBwdThreads;
    if (c < H) {
      dscale_part[pbase + c] = acc_dsc[j];
      dbias_part[pbase + c] = acc_dbi[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(const T* __restrict__ y, const float* __restrict__ b,
                 T* __restrict__ out, long long n, int F) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float z = to_f32(from_f32<T>(to_f32(y[i]) + b[i % F]));
    const float u = kSqrt2OverPi * (z + kGeluC * z * z * z);
    out[i] = from_f32<T>(0.5f * z * (1.f + tanhf(u)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kGeluBwdThreads)
bias_gelu_bwd_kernel(const T* __restrict__ y, const float* __restrict__ b,
                     const T* __restrict__ g, T* __restrict__ dz_out,
                     float* __restrict__ db_part, int rows, int F,
                     int rows_per_split) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= F) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  const float bc = b[c];
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const long long i = static_cast<long long>(r) * F + c;
    const float z = to_f32(from_f32<T>(to_f32(y[i]) + bc));
    const float u = kSqrt2OverPi * (z + kGeluC * z * z * z);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + kGelu3C * z * z);
    const float dg = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
    const float dz = to_f32(g[i]) * dg;
    dz_out[i] = from_f32<T>(dz);
    acc += dz;
  }
  db_part[static_cast<long long>(blockIdx.y) * F + c] = acc;
}

template <typename T>
void launch_ln(const void* x, const void* d, const float* scale,
               const float* bias, void* s, void* y, int rows, int H,
               float eps, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(H + 32) * sizeof(float);
  if (d != nullptr) {
    ln_fwd_kernel<T, true><<<rows, kLnThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(d), scale, bias,
        static_cast<T*>(s), static_cast<T*>(y), H, eps);
  } else {
    ln_fwd_kernel<T, false><<<rows, kLnThreads, smem, st>>>(
        static_cast<const T*>(x), nullptr, scale, bias, nullptr,
        static_cast<T*>(y), H, eps);
  }
}

template <typename T>
void launch_ln_bwd(const void* s, const float* scale, const void* dy,
                   const void* gs, void* dx, float* dsc, float* dbi,
                   int rows, int H, int blocks, float eps, cudaStream_t st) {
  if (gs != nullptr) {
    ln_bwd_kernel<T, true><<<blocks, kLnBwdThreads, 0, st>>>(
        static_cast<const T*>(s), scale, static_cast<const T*>(dy),
        static_cast<const T*>(gs), static_cast<T*>(dx), dsc, dbi, rows, H,
        eps);
  } else {
    ln_bwd_kernel<T, false><<<blocks, kLnBwdThreads, 0, st>>>(
        static_cast<const T*>(s), scale, static_cast<const T*>(dy), nullptr,
        static_cast<T*>(dx), dsc, dbi, rows, H, eps);
  }
}

template <typename T>
void launch_gelu(const void* y, const float* b, void* out, long long n,
                 int F, cudaStream_t st) {
  long long blocks = (n + kGeluThreads - 1) / kGeluThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  bias_gelu_kernel<T><<<static_cast<int>(blocks), kGeluThreads, 0, st>>>(
      static_cast<const T*>(y), b, static_cast<T*>(out), n, F);
}

template <typename T>
void launch_gelu_bwd(const void* y, const float* b, const void* g, void* dz,
                     float* db_part, int rows, int F, int splits,
                     cudaStream_t st) {
  const int per = (rows + splits - 1) / splits;
  dim3 grid((F + kGeluBwdThreads - 1) / kGeluBwdThreads, splits);
  bias_gelu_bwd_kernel<T><<<grid, kGeluBwdThreads, 0, st>>>(
      static_cast<const T*>(y), b, static_cast<const T*>(g),
      static_cast<T*>(dz), db_part, rows, F, per);
}

}  // namespace

// x, d (nullable), s (nullable iff d is), y: [rows, H] contiguous in
// `dtype`; scale, bias: [H] fp32.
extern "C" int dstt_layer_norm(const void* x, const void* d,
                               const void* scale, const void* bias,
                               void* s, void* y, int rows, int H, float eps,
                               int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0 || static_cast<size_t>(H + 32) * sizeof(float) > kMaxLnSmem)
    return cudaErrorInvalidValue;
  if ((d == nullptr) != (s == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == kFloat32) {
    launch_ln<float>(x, d, sc, bi, s, y, rows, H, eps, st);
  } else if (dtype == kBFloat16) {
    launch_ln<__nv_bfloat16>(x, d, sc, bi, s, y, rows, H, eps, st);
  } else if (dtype == kFloat16) {
    launch_ln<__half>(x, d, sc, bi, s, y, rows, H, eps, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Number of blocks (= rows of the dscale/dbias partials) that
// dstt_layer_norm_bwd launches for `rows` rows.
extern "C" int dstt_layer_norm_bwd_blocks(int rows) {
  return rows < kLnBwdMaxBlocks ? rows : kLnBwdMaxBlocks;
}

// s, dy, gs (nullable), dx: [rows, H] contiguous in `dtype`; scale: [H]
// fp32; dscale_part, dbias_part: [dstt_layer_norm_bwd_blocks(rows), H]
// fp32, every element written.
extern "C" int dstt_layer_norm_bwd(const void* s, const void* scale,
                                   const void* dy, const void* gs, void* dx,
                                   void* dscale_part, void* dbias_part,
                                   int rows, int H, float eps, int dtype,
                                   void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0 || H > kLnBwdCols * kLnBwdThreads) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = dstt_layer_norm_bwd_blocks(rows);
  const float* sc = static_cast<const float*>(scale);
  float* dsc = static_cast<float*>(dscale_part);
  float* dbi = static_cast<float*>(dbias_part);
  if (dtype == kFloat32) {
    launch_ln_bwd<float>(s, sc, dy, gs, dx, dsc, dbi, rows, H, blocks, eps,
                         st);
  } else if (dtype == kBFloat16) {
    launch_ln_bwd<__nv_bfloat16>(s, sc, dy, gs, dx, dsc, dbi, rows, H,
                                 blocks, eps, st);
  } else if (dtype == kFloat16) {
    launch_ln_bwd<__half>(s, sc, dy, gs, dx, dsc, dbi, rows, H, blocks, eps,
                          st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// y, out: [n / F, F] contiguous in `dtype`; b: [F] fp32.
extern "C" int dstt_bias_gelu(const void* y, const void* b, void* out,
                              long long n, int F, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F <= 0 || n % F != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (dtype == kFloat32) {
    launch_gelu<float>(y, bf, out, n, F, st);
  } else if (dtype == kBFloat16) {
    launch_gelu<__nv_bfloat16>(y, bf, out, n, F, st);
  } else if (dtype == kFloat16) {
    launch_gelu<__half>(y, bf, out, n, F, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Number of row splits (= rows of the dbias partials) that
// dstt_bias_gelu_bwd launches for `rows` rows.
extern "C" int dstt_bias_gelu_bwd_splits(int rows) {
  return rows < kGeluBwdRowSplits ? rows : kGeluBwdRowSplits;
}

// y, g, dz: [rows, F] contiguous in `dtype`; b: [F] fp32; db_part:
// [dstt_bias_gelu_bwd_splits(rows), F] fp32, every element written.
extern "C" int dstt_bias_gelu_bwd(const void* y, const void* b,
                                  const void* g, void* dz, void* db_part,
                                  int rows, int F, int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (F <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = dstt_bias_gelu_bwd_splits(rows);
  const float* bf = static_cast<const float*>(b);
  float* dbp = static_cast<float*>(db_part);
  if (dtype == kFloat32) {
    launch_gelu_bwd<float>(y, bf, g, dz, dbp, rows, F, splits, st);
  } else if (dtype == kBFloat16) {
    launch_gelu_bwd<__nv_bfloat16>(y, bf, g, dz, dbp, rows, F, splits, st);
  } else if (dtype == kFloat16) {
    launch_gelu_bwd<__half>(y, bf, g, dz, dbp, rows, F, splits, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
