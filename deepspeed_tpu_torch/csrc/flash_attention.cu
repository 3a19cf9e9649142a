// Flash attention: the forward and its three backward kernels, dense or
// causal, with in-kernel dropout from a position hash.
//
// Replaces (TPU, Pallas), deepspeed_tpu/ops/flash_attention.py:
//   _fwd_kernel       (K1)  -> flash_fwd_kernel
//   _bwd_dq_kernel    (K2a) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel   (K2b) -> flash_bwd_dkv_kernel
//   _bwd_fused_kernel (K2c) -> flash_bwd_fused_kernel
// The layout-gated (block-sparse) mode of those kernels is not here: it
// serves only the sparse attention, which is ported with K7/K8.
//
// Layouts. q, k, v are read through strides straight from the model's
// [B, S, nH, D] views (the split of the fused QKV projection): element
// (b, s, n, d) sits at b*sB + s*sS + n*sH + d; all three share the
// strides. o, dout, dq, dk, dv are contiguous [B, S, nH, D]; lse and
// delta are fp32 [B*nH, S]. The dropout hash's head index is
// bh = b*nH + n, the JAX package's _to_bh order.
//
// Bound on an H100. The work is the two (forward) or five (fused
// backward) matrix products over the (q, k) pairs the causal rule keeps,
// plus one exponential per pair and pass: at gpt2-small (B*nH = 96,
// S = 1024, D = 64) the products need ~13 GFLOP forward against ~13 MB
// of q/k/v/o, so the tensor-core rate bounds them, and the exponentials
// (~50 M per pass, on the SFUs) take about as long as the products.
//
// Design. The TPU grid walks k-blocks sequentially and carries the
// softmax state in VMEM scratch; CUDA blocks run in no order, so each
// block owns one q-tile (forward, dq) or one k-tile (dk/dv) and loops
// over the other axis itself, only as far as the causal diagonal. Tiles
// are 64 x 64 for bf16/fp16 (32 x 32 for fp32) and staged in shared
// memory; the products run on tensor cores through nvcuda::wmma
// m16n16k16 (bf16/fp16 in, fp32 accumulate) and, for fp32 inputs, as
// plain fp32 FMAs (true fp32, no TF32). Scores, probabilities and
// accumulators stay fp32 in shared memory; P and dS are rounded to the
// input type exactly where the TPU kernels round them (before PV, before
// the dq/dk products; l sums the undropped p; a kept element is scaled
// by the fp32 constant 1/(1-rate)). Masked scores are -1e30, as in the
// TPU kernels. The fused backward runs one block per (batch, head): it
// walks k-tiles outward and q-tiles inward from the diagonal, keeps the
// k-tile's dk/dv in shared memory and adds each tile's dq into an fp32
// workspace only this block touches, then casts it. No kernel uses
// atomics, so two launches on the same inputs give the same bits. This
// is the simple form: no TMA, no wgmma, no software pipelining.
#include <cstdint>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

using namespace dstt;

namespace {

constexpr int kThreads = 128;       // forward, dq, dk/dv
constexpr int kFusedThreads = 256;  // fused backward: one block per head
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
constexpr bool kScalar = std::is_same<T, float>::value;

// Tile edge (query rows = key columns per tile).
template <typename T>
constexpr int kTile = kScalar<T> ? 32 : 64;

// Row pitch of a [tile][tile] score tile and of a [tile][D] tile, in
// elements: multiples of 8, as wmma wants for 16-bit and fp32 tiles.
template <typename T>
constexpr int kLds = kTile<T> + 8;
__host__ __device__ constexpr int ldd(int D) { return D + 8; }

__host__ __device__ constexpr size_t rup(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Bump allocator over the block's dynamic shared memory (128-byte
// aligned pieces, as wmma's 32-byte pointer alignment needs).
struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += rup(n * sizeof(U));
    return r;
  }
};

// The regenerable dropout decision of _dropout_keep: murmur3 finalizer
// over qpos * 0x9E3779B9 + kpos + (seed ^ bh * 0x85EBCA6B), uint32
// wraparound; keep iff the top 24 bits as a [0, 1) float >= rate.
__device__ __forceinline__ bool keep_elem(uint32_t stream, uint32_t qpos,
                                          uint32_t kpos, float rate) {
  uint32_t x = qpos * 0x9E3779B9u + kpos;
  x += stream;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  const float u = static_cast<float>(static_cast<int>(x >> 8)) *
                  (1.0f / 16777216.0f);
  return u >= rate;
}

__device__ __forceinline__ uint32_t hash_stream(const int* seed, int bh,
                                                bool drop) {
  return drop ? (static_cast<uint32_t>(seed[0]) ^
                 (static_cast<uint32_t>(bh) * 0x85EBCA6Bu))
              : 0u;
}

// C[M][N] (fp32, pitch ldc) = (acc ? C : 0) + op(A) * op(B), op(A) M x K
// and op(B) K x N. A is stored [M][K] (pitch lda), or [K][M] when TA; B
// is stored [K][N], or [N][K] when TB. M, N, K are multiples of 16. The
// whole block calls it; each warp owns 16 x 16 output tiles. C may be in
// shared or global memory.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void tile_mm(const T* A, int lda, const T* B,
                                        int ldb, float* C, int ldc, int M,
                                        int N, int K, bool acc) {
  if constexpr (kScalar<T>) {
    for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
      const int i = idx / N;
      const int j = idx - i * N;
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) {
        const float a = TA ? A[kk * lda + i] : A[i * lda + kk];
        const float b = TB ? B[j * ldb + kk] : B[kk * ldb + j];
        s = fmaf(a, b, s);
      }
      C[i * ldc + j] = acc ? C[i * ldc + j] + s : s;
    }
  } else {
    using namespace nvcuda;
    using LA = std::conditional_t<TA, wmma::col_major, wmma::row_major>;
    using LB = std::conditional_t<TB, wmma::col_major, wmma::row_major>;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int nt = N / 16;
    for (int f = warp; f < (M / 16) * nt; f += nwarps) {
      const int i = (f / nt) * 16;
      const int j = (f - (f / nt) * nt) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc)
        wmma::load_matrix_sync(c, C + i * ldc + j, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(a, TA ? A + kk * lda + i : A + i * lda + kk,
                               lda);
        wmma::load_matrix_sync(b, TB ? B + j * ldb + kk : B + kk * ldb + j,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i * ldc + j, c, ldc, wmma::mem_row_major);
    }
  }
}

// R rows of D elements from global (row stride `stride` elements) into
// shared memory (pitch ld), 16 bytes per thread and step.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int R, int D) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = D / V;
  for (int idx = threadIdx.x; idx < R * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * V;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ void fill(float* p, int n, float v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = v;
}

// Shared bytes of each kernel (host and device agree on the carve-up).
template <typename T>
size_t fwd_smem(int D) {
  constexpr int t = kTile<T>, ls = kLds<T>;
  return 3 * rup(t * ldd(D) * sizeof(T)) + rup(t * ls * sizeof(float)) +
         (kScalar<T> ? 0 : rup(t * ls * sizeof(T))) +
         rup(t * ldd(D) * sizeof(float)) + 2 * rup(t * sizeof(float));
}

template <typename T>
size_t dq_smem(int D) {
  constexpr int t = kTile<T>, ls = kLds<T>;
  return 4 * rup(t * ldd(D) * sizeof(T)) + 2 * rup(t * ls * sizeof(float)) +
         (kScalar<T> ? 0 : rup(t * ls * sizeof(T))) +
         rup(t * ldd(D) * sizeof(float)) + 2 * rup(t * sizeof(float));
}

template <typename T>
size_t dkv_smem(int D) {  // also the fused backward's
  constexpr int t = kTile<T>, ls = kLds<T>;
  return 4 * rup(t * ldd(D) * sizeof(T)) + 2 * rup(t * ls * sizeof(float)) +
         (kScalar<T> ? 0 : 2 * rup(t * ls * sizeof(T))) +
         2 * rup(t * ldd(D) * sizeof(float)) + 2 * rup(t * sizeof(float));
}

// Common launch arguments.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long sB, sS, sH;  // q/k/v strides (elements)
  const void* dout;      // contiguous [B, S, nH, D]
  float* lse;            // [B*nH, S]
  const float* delta;    // [B*nH, S]
  void* o;               // forward output
  void* dq;
  void* dk;
  void* dv;
  float* dq_ws;          // fused: fp32 [B*nH, S, D]
  const int* seed;
  int nH, S, D;
  float scale, rate, inv_keep;
  int causal;
};

// Offsets of one (b, n) head: strided q/k/v, contiguous [B, S, nH, D].
struct Head {
  long long in, out;
  long long out_stride;
  __device__ Head(const Args& a, int bh) {
    const int b = bh / a.nH;
    const int n = bh - b * a.nH;
    in = static_cast<long long>(b) * a.sB + static_cast<long long>(n) * a.sH;
    out = (static_cast<long long>(b) * a.S * a.nH + n) * a.D;
    out_stride = static_cast<long long>(a.nH) * a.D;
  }
};

// --------------------------------------------------------------------- //
// K1: forward
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int t = kTile<T>, LS = kLds<T>;
  const int D = a.D, LD = ldd(D);
  // Long causal rows first: q-tiles run in reverse launch order.
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(t * LD);
  T* Ks = cv.take<T>(t * LD);
  T* Vs = cv.take<T>(t * LD);
  float* Ss = cv.take<float>(t * LS);
  T* Ps;
  if constexpr (kScalar<T>) Ps = reinterpret_cast<T*>(Ss);
  else Ps = cv.take<T>(t * LS);
  float* acc = cv.take<float>(t * LD);
  float* m_s = cv.take<float>(t);
  float* l_s = cv.take<float>(t);

  const Head h(a, bh);
  const T* q = static_cast<const T*>(a.q) + h.in;
  const T* k = static_cast<const T*>(a.k) + h.in;
  const T* v = static_cast<const T*>(a.v) + h.in;
  const bool drop = a.rate > 0.f;
  const uint32_t stream = hash_stream(a.seed, bh, drop);

  load_rows(Qs, LD, q + static_cast<long long>(qi) * t * a.sS, a.sS, t, D);
  fill(acc, t * LD, 0.f);
  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int nk = a.causal ? qi + 1 : a.S / t;
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();  // the last tile's readers of K, V and P are done
    const long long off = static_cast<long long>(kj) * t * a.sS;
    load_rows(Ks, LD, k + off, a.sS, t, D);
    load_rows(Vs, LD, v + off, a.sS, t, D);
    __syncthreads();
    tile_mm<T, false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
    __syncthreads();
    // Online softmax, one warp per row: m_new, alpha, l += sum(p) of the
    // undropped p, then the dropped p rounded to T for the PV product.
    for (int r = warp; r < t; r += nwarps) {
      const int qpos = qi * t + r;
      float sv[t / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < t / 32; ++u) {
        const int c = lane + 32 * u;
        float x = Ss[r * LS + c] * a.scale;
        if (a.causal && kj * t + c > qpos) x = kNegInf;
        sv[u] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < t / 32; ++u) {
        const int c = lane + 32 * u;
        float p = expf(sv[u] - m_new);
        psum += p;
        if (drop)
          p = keep_elem(stream, qpos, kj * t + c, a.rate) ? p * a.inv_keep
                                                          : 0.f;
        Ps[r * LS + c] = from_f32<T>(p);
      }
      psum = warp_sum(psum);
      for (int d = lane; d < D; d += 32) acc[r * LD + d] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncthreads();
    tile_mm<T, false, false>(Ps, LS, Vs, LD, acc, LD, t, D, t, true);
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + h.out;
  for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const float l = l_s[r];
    o[static_cast<long long>(qi * t + r) * h.out_stride + d] =
        from_f32<T>(acc[r * LD + d] / (l == 0.f ? 1.f : l));
  }
  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    const float l = l_s[r];
    a.lse[static_cast<long long>(bh) * a.S + qi * t + r] =
        m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

// The backward's per-element step, in the (q row, k column) orientation:
// p from the saved lse, the dropout mask applied to p (for dv) and to dp,
// ds = p * (dp - delta) * scale. Returns (p_drop, ds).
struct Grad {
  float pd, ds;
};
__device__ __forceinline__ Grad grad_elem(const Args& a, uint32_t stream,
                                          bool drop, int qpos, int kpos,
                                          float s, float dp, float lse,
                                          float delta) {
  s *= a.scale;
  if (a.causal && kpos > qpos) s = kNegInf;
  const float p = expf(s - lse);
  float pd = p;
  if (drop) {
    const bool keep = keep_elem(stream, qpos, kpos, a.rate);
    pd = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  return {pd, p * (dp - delta) * a.scale};
}

// --------------------------------------------------------------------- //
// K2a: dq over q rows
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int t = kTile<T>, LS = kLds<T>;
  const int D = a.D, LD = ldd(D);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(t * LD);
  T* dOs = cv.take<T>(t * LD);
  T* Ks = cv.take<T>(t * LD);
  T* Vs = cv.take<T>(t * LD);
  float* Ss = cv.take<float>(t * LS);
  float* dPs = cv.take<float>(t * LS);
  T* dSs;
  if constexpr (kScalar<T>) dSs = reinterpret_cast<T*>(dPs);
  else dSs = cv.take<T>(t * LS);
  float* dQ = cv.take<float>(t * LD);
  float* lse_s = cv.take<float>(t);
  float* delta_s = cv.take<float>(t);

  const Head h(a, bh);
  const T* q = static_cast<const T*>(a.q) + h.in;
  const T* k = static_cast<const T*>(a.k) + h.in;
  const T* v = static_cast<const T*>(a.v) + h.in;
  const T* dout = static_cast<const T*>(a.dout) + h.out;
  const bool drop = a.rate > 0.f;
  const uint32_t stream = hash_stream(a.seed, bh, drop);

  load_rows(Qs, LD, q + static_cast<long long>(qi) * t * a.sS, a.sS, t, D);
  load_rows(dOs, LD, dout + static_cast<long long>(qi) * t * h.out_stride,
            h.out_stride, t, D);
  fill(dQ, t * LD, 0.f);
  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    lse_s[r] = a.lse[static_cast<long long>(bh) * a.S + qi * t + r];
    delta_s[r] = a.delta[static_cast<long long>(bh) * a.S + qi * t + r];
  }
  const int nk = a.causal ? qi + 1 : a.S / t;
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    const long long off = static_cast<long long>(kj) * t * a.sS;
    load_rows(Ks, LD, k + off, a.sS, t, D);
    load_rows(Vs, LD, v + off, a.sS, t, D);
    __syncthreads();
    tile_mm<T, false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
    tile_mm<T, false, true>(dOs, LD, Vs, LD, dPs, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;
      const int c = idx - r * t;
      const Grad g = grad_elem(a, stream, drop, qi * t + r, kj * t + c,
                               Ss[r * LS + c], dPs[r * LS + c], lse_s[r],
                               delta_s[r]);
      dSs[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<T, false, false>(dSs, LS, Ks, LD, dQ, LD, t, D, t, true);
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.dq) + h.out;
  for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    dq[static_cast<long long>(qi * t + r) * h.out_stride + d] =
        from_f32<T>(dQ[r * LD + d]);
  }
}

// --------------------------------------------------------------------- //
// K2b: dk and dv over k columns (transposed tiles: rows are keys)
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int t = kTile<T>, LS = kLds<T>;
  const int D = a.D, LD = ldd(D);
  const int kj = blockIdx.y, bh = blockIdx.x;  // k-tile 0 has most work
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(t * LD);
  T* Vs = cv.take<T>(t * LD);
  T* Qs = cv.take<T>(t * LD);
  T* dOs = cv.take<T>(t * LD);
  float* S2 = cv.take<float>(t * LS);
  float* dP2 = cv.take<float>(t * LS);
  T* P2d;
  T* dS2;
  if constexpr (kScalar<T>) {
    P2d = reinterpret_cast<T*>(S2);
    dS2 = reinterpret_cast<T*>(dP2);
  } else {
    P2d = cv.take<T>(t * LS);
    dS2 = cv.take<T>(t * LS);
  }
  float* dK = cv.take<float>(t * LD);
  float* dV = cv.take<float>(t * LD);
  float* lse_s = cv.take<float>(t);
  float* delta_s = cv.take<float>(t);

  const Head h(a, bh);
  const T* q = static_cast<const T*>(a.q) + h.in;
  const T* k = static_cast<const T*>(a.k) + h.in;
  const T* v = static_cast<const T*>(a.v) + h.in;
  const T* dout = static_cast<const T*>(a.dout) + h.out;
  const bool drop = a.rate > 0.f;
  const uint32_t stream = hash_stream(a.seed, bh, drop);

  const long long koff = static_cast<long long>(kj) * t * a.sS;
  load_rows(Ks, LD, k + koff, a.sS, t, D);
  load_rows(Vs, LD, v + koff, a.sS, t, D);
  fill(dK, t * LD, 0.f);
  fill(dV, t * LD, 0.f);
  const int nq = a.S / t;
  for (int qi = a.causal ? kj : 0; qi < nq; ++qi) {
    __syncthreads();
    load_rows(Qs, LD, q + static_cast<long long>(qi) * t * a.sS, a.sS, t, D);
    load_rows(dOs, LD, dout + static_cast<long long>(qi) * t * h.out_stride,
              h.out_stride, t, D);
    for (int c = threadIdx.x; c < t; c += blockDim.x) {
      lse_s[c] = a.lse[static_cast<long long>(bh) * a.S + qi * t + c];
      delta_s[c] = a.delta[static_cast<long long>(bh) * a.S + qi * t + c];
    }
    __syncthreads();
    tile_mm<T, false, true>(Ks, LD, Qs, LD, S2, LS, t, t, D, false);
    tile_mm<T, false, true>(Vs, LD, dOs, LD, dP2, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;  // key row
      const int c = idx - r * t;  // query column
      const Grad g = grad_elem(a, stream, drop, qi * t + c, kj * t + r,
                               S2[r * LS + c], dP2[r * LS + c], lse_s[c],
                               delta_s[c]);
      P2d[r * LS + c] = from_f32<T>(g.pd);
      dS2[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<T, false, false>(P2d, LS, dOs, LD, dV, LD, t, D, t, true);
    tile_mm<T, false, false>(dS2, LS, Qs, LD, dK, LD, t, D, t, true);
  }
  __syncthreads();
  T* dk = static_cast<T*>(a.dk) + h.out;
  T* dv = static_cast<T*>(a.dv) + h.out;
  for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const long long o = static_cast<long long>(kj * t + r) * h.out_stride + d;
    dk[o] = from_f32<T>(dK[r * LD + d]);
    dv[o] = from_f32<T>(dV[r * LD + d]);
  }
}

// --------------------------------------------------------------------- //
// K2c: fused whole-sequence backward, one block per (batch, head)
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
flash_bwd_fused_kernel(Args a) {
  constexpr int t = kTile<T>, LS = kLds<T>;
  const int D = a.D, LD = ldd(D);
  const int bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(t * LD);
  T* Vs = cv.take<T>(t * LD);
  T* Qs = cv.take<T>(t * LD);
  T* dOs = cv.take<T>(t * LD);
  float* Ss = cv.take<float>(t * LS);
  float* dPs = cv.take<float>(t * LS);
  T* Pd;
  T* dSs;
  if constexpr (kScalar<T>) {
    Pd = reinterpret_cast<T*>(Ss);
    dSs = reinterpret_cast<T*>(dPs);
  } else {
    Pd = cv.take<T>(t * LS);
    dSs = cv.take<T>(t * LS);
  }
  float* dK = cv.take<float>(t * LD);
  float* dV = cv.take<float>(t * LD);
  float* lse_s = cv.take<float>(t);
  float* delta_s = cv.take<float>(t);

  const Head h(a, bh);
  const T* q = static_cast<const T*>(a.q) + h.in;
  const T* k = static_cast<const T*>(a.k) + h.in;
  const T* v = static_cast<const T*>(a.v) + h.in;
  const T* dout = static_cast<const T*>(a.dout) + h.out;
  float* ws = a.dq_ws + static_cast<long long>(bh) * a.S * D;
  const bool drop = a.rate > 0.f;
  const uint32_t stream = hash_stream(a.seed, bh, drop);
  const int n = a.S / t;
  T* dk = static_cast<T*>(a.dk) + h.out;
  T* dv = static_cast<T*>(a.dv) + h.out;

  for (int kj = 0; kj < n; ++kj) {
    __syncthreads();
    const long long koff = static_cast<long long>(kj) * t * a.sS;
    load_rows(Ks, LD, k + koff, a.sS, t, D);
    load_rows(Vs, LD, v + koff, a.sS, t, D);
    fill(dK, t * LD, 0.f);
    fill(dV, t * LD, 0.f);
    for (int qi = a.causal ? kj : 0; qi < n; ++qi) {
      __syncthreads();
      load_rows(Qs, LD, q + static_cast<long long>(qi) * t * a.sS, a.sS, t,
                D);
      load_rows(dOs, LD,
                dout + static_cast<long long>(qi) * t * h.out_stride,
                h.out_stride, t, D);
      for (int r = threadIdx.x; r < t; r += blockDim.x) {
        lse_s[r] = a.lse[static_cast<long long>(bh) * a.S + qi * t + r];
        delta_s[r] = a.delta[static_cast<long long>(bh) * a.S + qi * t + r];
      }
      __syncthreads();
      tile_mm<T, false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
      tile_mm<T, false, true>(dOs, LD, Vs, LD, dPs, LS, t, t, D, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
        const int r = idx / t;
        const int c = idx - r * t;
        const Grad g = grad_elem(a, stream, drop, qi * t + r, kj * t + c,
                                 Ss[r * LS + c], dPs[r * LS + c], lse_s[r],
                                 delta_s[r]);
        Pd[r * LS + c] = from_f32<T>(g.pd);
        dSs[r * LS + c] = from_f32<T>(g.ds);
      }
      __syncthreads();
      // dv += p_drop^T dO, dk += dS^T Q, dq(tile qi) += dS K. The first
      // k-tile (kj = 0) reaches every q-tile, so it initialises dq.
      tile_mm<T, true, false>(Pd, LS, dOs, LD, dV, LD, t, D, t, true);
      tile_mm<T, true, false>(dSs, LS, Qs, LD, dK, LD, t, D, t, true);
      tile_mm<T, false, false>(dSs, LS, Ks, LD,
                               ws + static_cast<long long>(qi) * t * D, D, t,
                               D, t, kj > 0);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      const long long o =
          static_cast<long long>(kj * t + r) * h.out_stride + d;
      dk[o] = from_f32<T>(dK[r * LD + d]);
      dv[o] = from_f32<T>(dV[r * LD + d]);
    }
  }
  __syncthreads();  // every dq tile is final (block-local global writes)
  T* dq = static_cast<T*>(a.dq) + h.out;
  for (int idx = threadIdx.x; idx < a.S * D; idx += blockDim.x) {
    const int s = idx / D;
    const int d = idx - s * D;
    dq[static_cast<long long>(s) * h.out_stride + d] = from_f32<T>(ws[idx]);
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

template <typename T>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t st) {
  const int bh = B * a.nH;
  const int nt = a.S / kTile<T>;
  void (*kern)(Args);
  size_t smem;
  dim3 grid(bh, nt);
  int threads = kThreads;
  switch (kind) {
    case kFwd:
      kern = flash_fwd_kernel<T>;
      smem = fwd_smem<T>(a.D);
      break;
    case kDq:
      kern = flash_bwd_dq_kernel<T>;
      smem = dq_smem<T>(a.D);
      break;
    case kDkv:
      kern = flash_bwd_dkv_kernel<T>;
      smem = dkv_smem<T>(a.D);
      break;
    default:
      kern = flash_bwd_fused_kernel<T>;
      smem = dkv_smem<T>(a.D);
      grid = dim3(bh);
      threads = kFusedThreads;
      break;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

int dispatch(Kind kind, Args& a, int B, int dtype, void* stream) {
  if (B <= 0 || a.nH <= 0 || a.S <= 0) return cudaSuccess;
  if (a.D % 16 != 0 || a.D < 16 || a.D > 128) return cudaErrorInvalidValue;
  if (a.rate > 0.f && a.seed == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32:
      if (a.S % kTile<float> != 0) return cudaErrorInvalidValue;
      e = launch<float>(kind, a, B, st);
      break;
    case kBFloat16:
      if (a.S % kTile<__nv_bfloat16> != 0) return cudaErrorInvalidValue;
      e = launch<__nv_bfloat16>(kind, a, B, st);
      break;
    case kFloat16:
      if (a.S % kTile<__half> != 0) return cudaErrorInvalidValue;
      e = launch<__half>(kind, a, B, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

Args make_args(const void* q, const void* k, const void* v, long long sB,
               long long sS, long long sH, const void* seed, int nH, int S,
               int D, float scale, float rate, float inv_keep, int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.sB = sB;
  a.sS = sS;
  a.sH = sH;
  a.seed = static_cast<const int*>(seed);
  a.nH = nH;
  a.S = S;
  a.D = D;
  a.scale = scale;
  a.rate = rate;
  a.inv_keep = inv_keep;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              long long sB, long long sS, long long sH,
                              void* o, void* lse, const void* seed, int B,
                              int nH, int S, int D, float scale, float rate,
                              float inv_keep, int causal, int dtype,
                              void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, nH, S, D, scale, rate,
                     inv_keep, causal);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, B, dtype, stream);
}

extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 long long sB, long long sS, long long sH,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* seed, int B, int nH, int S,
                                 int D, float scale, float rate,
                                 float inv_keep, int causal, int dtype,
                                 void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, nH, S, D, scale, rate,
                     inv_keep, causal);
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return dispatch(kDq, a, B, dtype, stream);
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, long long sB, long long sS,
                                  long long sH, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* seed, int B,
                                  int nH, int S, int D, float scale,
                                  float rate, float inv_keep, int causal,
                                  int dtype, void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, nH, S, D, scale, rate,
                     inv_keep, causal);
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, a, B, dtype, stream);
}

extern "C" int dstt_flash_bwd_fused(const void* q, const void* k,
                                    const void* v, long long sB,
                                    long long sS, long long sH,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, void* dk,
                                    void* dv, void* dq_ws, const void* seed,
                                    int B, int nH, int S, int D, float scale,
                                    float rate, float inv_keep, int causal,
                                    int dtype, void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, nH, S, D, scale, rate,
                     inv_keep, causal);
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_ws = static_cast<float*>(dq_ws);
  return dispatch(kFused, a, B, dtype, stream);
}
