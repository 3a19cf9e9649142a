// Tile code shared by the flash attention kernels (flash_attention.cu) and
// the block-sparse ones (sparse_flash.cu): the tile sizes and shared-memory
// carve-up, the dropout hash, the tensor-core tile product, and one step
// of each pass over a (q-tile, k-tile) pair — the forward's online softmax,
// the dq pass and the dk/dv pass. A kernel decides which pairs it visits
// (the causal diagonal, a layout gate, a block-sparse lookup table) and
// calls the steps in a fixed order, so two launches give the same bits.
//
// Numerics (the TPU kernels'): fp32 scores (q.k) * scale; a masked element
// (causal) has score -1e30 and probability exactly 0; the softmax
// normalizer l sums the undropped p; a kept element is scaled by the fp32
// constant 1/(1-rate); P is rounded to the input type before PV, dS and
// p_drop before their products; fp32 accumulation throughout.
#pragma once

#include <cstdint>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

namespace dstt {
namespace flash {

constexpr int kThreads = 128;       // one warp group per block
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

// Shared bytes of each pass (host and device agree on the carve-up).
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
size_t dkv_smem(int D) {  // also the fused backwards'
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
  float* dq_ws;          // fused backwards: fp32 dq workspace
  const int* seed;
  // Layout gate (flash kernels): int32 [nH, nb, nb], nullptr = ungated;
  // element (h, i, j) gates the (q-block i, k-block j) pair of lay_block
  // x lay_block elements.
  const int* layout;
  int lay_nb, lay_block;
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

// One head's operands, offset to its first row, and its dropout stream.
template <typename T>
struct HeadPtrs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  long long sS, out_stride, out;
  float* lse;          // this head's row of [B*nH, S]
  const float* delta;
  bool drop;
  uint32_t stream;
  __device__ HeadPtrs(const Args& a, int bh) {
    const Head h(a, bh);
    q = static_cast<const T*>(a.q) + h.in;
    k = static_cast<const T*>(a.k) + h.in;
    v = static_cast<const T*>(a.v) + h.in;
    dout = a.dout ? static_cast<const T*>(a.dout) + h.out : nullptr;
    sS = a.sS;
    out_stride = h.out_stride;
    out = h.out;
    lse = a.lse + static_cast<long long>(bh) * a.S;
    delta = a.delta ? a.delta + static_cast<long long>(bh) * a.S : nullptr;
    drop = a.rate > 0.f;
    stream = hash_stream(a.seed, bh, drop);
  }
};

// The backward's per-element step, in the (q row, k column) orientation:
// p from the saved lse (exactly 0 where masked), the dropout mask applied
// to p (for dv) and to dp, ds = p * (dp - delta) * scale. Returns
// (p_drop, ds).
struct Grad {
  float pd, ds;
};
__device__ __forceinline__ Grad grad_elem(const Args& a, uint32_t stream,
                                          bool drop, int qpos, int kpos,
                                          float s, float dp, float lse,
                                          float delta) {
  const bool masked = a.causal && kpos > qpos;
  const float p = masked ? 0.f : expf(s * a.scale - lse);
  float pd = p;
  if (drop) {
    const bool keep = keep_elem(stream, qpos, kpos, a.rate);
    pd = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  return {pd, p * (dp - delta) * a.scale};
}

// --------------------------------------------------------------------- //
// The forward over one q-tile: begin, one step per visited k-tile, end.
// --------------------------------------------------------------------- //
template <typename T>
struct FwdTiles {
  T* Qs;
  T* Ks;
  T* Vs;
  float* Ss;
  T* Ps;
  float* acc;
  float* m_s;
  float* l_s;
  __device__ FwdTiles(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Qs = cv.take<T>(t * LD);
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Ss = cv.take<float>(t * LS);
    if constexpr (kScalar<T>) Ps = reinterpret_cast<T*>(Ss);
    else Ps = cv.take<T>(t * LS);
    acc = cv.take<float>(t * LD);
    m_s = cv.take<float>(t);
    l_s = cv.take<float>(t);
  }

  __device__ void begin(const HeadPtrs<T>& hp, int qt, int D) {
    constexpr int t = kTile<T>;
    load_rows(Qs, ldd(D), hp.q + static_cast<long long>(qt) * t * hp.sS,
              hp.sS, t, D);
    fill(acc, t * ldd(D), 0.f);
    for (int r = threadIdx.x; r < t; r += blockDim.x) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
  }

  // Online softmax over k-tile kt: m_new, alpha, l += sum(p) of the
  // undropped p, then the dropped p rounded to T for the PV product.
  __device__ void step(const Args& a, const HeadPtrs<T>& hp, int qt,
                       int kt) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int D = a.D, LD = ldd(D);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    __syncthreads();  // the last tile's readers of K, V and P are done
    const long long off = static_cast<long long>(kt) * t * hp.sS;
    load_rows(Ks, LD, hp.k + off, hp.sS, t, D);
    load_rows(Vs, LD, hp.v + off, hp.sS, t, D);
    __syncthreads();
    tile_mm<T, false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
    __syncthreads();
    for (int r = warp; r < t; r += nwarps) {
      const int qpos = qt * t + r;
      float sv[t / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < t / 32; ++u) {
        const int c = lane + 32 * u;
        float x = Ss[r * LS + c] * a.scale;
        if (a.causal && kt * t + c > qpos) x = kNegInf;
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
        float p = sv[u] == kNegInf ? 0.f : expf(sv[u] - m_new);
        psum += p;
        if (hp.drop)
          p = keep_elem(hp.stream, qpos, kt * t + c, a.rate) ? p * a.inv_keep
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

  // o = acc / l (0 for a row that saw no key), lse = m + log(l).
  __device__ void end(const Args& a, const HeadPtrs<T>& hp, int qt) {
    constexpr int t = kTile<T>;
    const int D = a.D, LD = ldd(D);
    __syncthreads();
    T* o = static_cast<T*>(a.o) + hp.out;
    for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      const float l = l_s[r];
      o[static_cast<long long>(qt * t + r) * hp.out_stride + d] =
          from_f32<T>(acc[r * LD + d] / (l == 0.f ? 1.f : l));
    }
    for (int r = threadIdx.x; r < t; r += blockDim.x) {
      const float l = l_s[r];
      hp.lse[qt * t + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
};

// --------------------------------------------------------------------- //
// dq over one q-tile: begin, one step per visited k-tile, end.
// --------------------------------------------------------------------- //
template <typename T>
struct DqTiles {
  T* Qs;
  T* dOs;
  T* Ks;
  T* Vs;
  float* Ss;
  float* dPs;
  T* dSs;
  float* dQ;
  float* lse_s;
  float* delta_s;
  __device__ DqTiles(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Qs = cv.take<T>(t * LD);
    dOs = cv.take<T>(t * LD);
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Ss = cv.take<float>(t * LS);
    dPs = cv.take<float>(t * LS);
    if constexpr (kScalar<T>) dSs = reinterpret_cast<T*>(dPs);
    else dSs = cv.take<T>(t * LS);
    dQ = cv.take<float>(t * LD);
    lse_s = cv.take<float>(t);
    delta_s = cv.take<float>(t);
  }

  __device__ void begin(const HeadPtrs<T>& hp, int qt, int D) {
    constexpr int t = kTile<T>;
    load_rows(Qs, ldd(D), hp.q + static_cast<long long>(qt) * t * hp.sS,
              hp.sS, t, D);
    load_rows(dOs, ldd(D),
              hp.dout + static_cast<long long>(qt) * t * hp.out_stride,
              hp.out_stride, t, D);
    fill(dQ, t * ldd(D), 0.f);
    for (int r = threadIdx.x; r < t; r += blockDim.x) {
      lse_s[r] = hp.lse[qt * t + r];
      delta_s[r] = hp.delta[qt * t + r];
    }
  }

  __device__ void step(const Args& a, const HeadPtrs<T>& hp, int qt,
                       int kt) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int D = a.D, LD = ldd(D);
    __syncthreads();
    const long long off = static_cast<long long>(kt) * t * hp.sS;
    load_rows(Ks, LD, hp.k + off, hp.sS, t, D);
    load_rows(Vs, LD, hp.v + off, hp.sS, t, D);
    __syncthreads();
    tile_mm<T, false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
    tile_mm<T, false, true>(dOs, LD, Vs, LD, dPs, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;
      const int c = idx - r * t;
      const Grad g = grad_elem(a, hp.stream, hp.drop, qt * t + r, kt * t + c,
                               Ss[r * LS + c], dPs[r * LS + c], lse_s[r],
                               delta_s[r]);
      dSs[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<T, false, false>(dSs, LS, Ks, LD, dQ, LD, t, D, t, true);
  }

  __device__ void end(const Args& a, const HeadPtrs<T>& hp, int qt) {
    constexpr int t = kTile<T>;
    const int D = a.D, LD = ldd(D);
    __syncthreads();
    T* dq = static_cast<T*>(a.dq) + hp.out;
    for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      dq[static_cast<long long>(qt * t + r) * hp.out_stride + d] =
          from_f32<T>(dQ[r * LD + d]);
    }
  }
};

// --------------------------------------------------------------------- //
// dk, dv over one k-tile (transposed tiles: rows are keys): begin, one
// step per visited q-tile, end. A step may also write the q-tile's dq
// partial dS^T K (fp32, [t][D]) to global memory (the fused backward).
// --------------------------------------------------------------------- //
template <typename T>
struct DkvTiles {
  T* Ks;
  T* Vs;
  T* Qs;
  T* dOs;
  float* S2;
  float* dP2;
  T* P2d;
  T* dS2;
  float* dK;
  float* dV;
  float* lse_s;
  float* delta_s;
  __device__ DkvTiles(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Qs = cv.take<T>(t * LD);
    dOs = cv.take<T>(t * LD);
    S2 = cv.take<float>(t * LS);
    dP2 = cv.take<float>(t * LS);
    if constexpr (kScalar<T>) {
      P2d = reinterpret_cast<T*>(S2);
      dS2 = reinterpret_cast<T*>(dP2);
    } else {
      P2d = cv.take<T>(t * LS);
      dS2 = cv.take<T>(t * LS);
    }
    dK = cv.take<float>(t * LD);
    dV = cv.take<float>(t * LD);
    lse_s = cv.take<float>(t);
    delta_s = cv.take<float>(t);
  }

  __device__ void begin(const HeadPtrs<T>& hp, int kt, int D) {
    constexpr int t = kTile<T>;
    const long long koff = static_cast<long long>(kt) * t * hp.sS;
    load_rows(Ks, ldd(D), hp.k + koff, hp.sS, t, D);
    load_rows(Vs, ldd(D), hp.v + koff, hp.sS, t, D);
    fill(dK, t * ldd(D), 0.f);
    fill(dV, t * ldd(D), 0.f);
  }

  __device__ void step(const Args& a, const HeadPtrs<T>& hp, int qt, int kt,
                       float* dq_part) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int D = a.D, LD = ldd(D);
    __syncthreads();
    load_rows(Qs, LD, hp.q + static_cast<long long>(qt) * t * hp.sS, hp.sS,
              t, D);
    load_rows(dOs, LD,
              hp.dout + static_cast<long long>(qt) * t * hp.out_stride,
              hp.out_stride, t, D);
    for (int c = threadIdx.x; c < t; c += blockDim.x) {
      lse_s[c] = hp.lse[qt * t + c];
      delta_s[c] = hp.delta[qt * t + c];
    }
    __syncthreads();
    tile_mm<T, false, true>(Ks, LD, Qs, LD, S2, LS, t, t, D, false);
    tile_mm<T, false, true>(Vs, LD, dOs, LD, dP2, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;      // key row
      const int c = idx - r * t;  // query column
      const Grad g = grad_elem(a, hp.stream, hp.drop, qt * t + c, kt * t + r,
                               S2[r * LS + c], dP2[r * LS + c], lse_s[c],
                               delta_s[c]);
      P2d[r * LS + c] = from_f32<T>(g.pd);
      dS2[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<T, false, false>(P2d, LS, dOs, LD, dV, LD, t, D, t, true);
    tile_mm<T, false, false>(dS2, LS, Qs, LD, dK, LD, t, D, t, true);
    if (dq_part != nullptr)
      tile_mm<T, true, false>(dS2, LS, Ks, LD, dq_part, D, t, D, t, false);
  }

  __device__ void end(const Args& a, const HeadPtrs<T>& hp, int kt) {
    constexpr int t = kTile<T>;
    const int D = a.D, LD = ldd(D);
    __syncthreads();
    T* dk = static_cast<T*>(a.dk) + hp.out;
    T* dv = static_cast<T*>(a.dv) + hp.out;
    for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      const long long o =
          static_cast<long long>(kt * t + r) * hp.out_stride + d;
      dk[o] = from_f32<T>(dK[r * LD + d]);
      dv[o] = from_f32<T>(dV[r * LD + d]);
    }
  }
};

// Allow `kern` `smem` bytes of dynamic shared memory (opt-in above 48 KB).
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace flash
}  // namespace dstt
