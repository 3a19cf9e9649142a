// Tile code shared by the flash attention kernels (flash_attention.cu) and
// the block-sparse ones (sparse_flash.cu): the tile sizes and shared-memory
// carve-up, the dropout hash, and one step of each pass over a (q-tile,
// k-tile) pair — the forward's online softmax, the dq pass and the dk/dv
// pass. A kernel decides which pairs it visits (the causal diagonal, a
// layout gate, a block-sparse lookup table) and calls the steps in a fixed
// order, so two launches give the same bits.
//
// Two forms of each pass: bf16/fp16 tiles are register-resident (64 x 64,
// mma.sync m16n8k16 from ldmatrix fragments, fp32 accumulate, operands
// streamed through a cp.async double buffer; FwdTiles, DqTiles, DkvTiles);
// fp32 tiles are 32 x 32 scalar FMAs in shared memory (true fp32, no TF32;
// FwdTilesScalar, DqTilesScalar, DkvTilesScalar). FwdOf, DqOf and DkvOf
// pick the form of a type.
//
// Numerics (the TPU kernels'): fp32 scores (q.k) * scale; a masked element
// (causal) has score -1e30 and probability exactly 0; the softmax
// normalizer l sums the undropped p; a kept element is scaled by the fp32
// constant 1/(1-rate); P is rounded to the input type before PV, dS and
// p_drop before their products; fp32 accumulation throughout.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace dstt {
namespace flash {

constexpr int kThreads = 128;       // one warp group per block
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
constexpr bool kScalar = std::is_same<T, float>::value;

// Tile edge (query rows = key columns per tile).
template <typename T>
constexpr int kTile = kScalar<T> ? 32 : 64;

// Row pitch of the scalar tiles' [tile][tile] score tile and [tile][D]
// tiles, in elements (padded by 8 against bank conflicts).
template <typename T>
constexpr int kLds = kTile<T> + 8;
__host__ __device__ constexpr int ldd(int D) { return D + 8; }

// DP, the register tiles' width for a head dim: 32, 64 or 128.
__host__ __device__ constexpr int dpad(int D) {
  return D <= 32 ? 32 : (D <= 64 ? 64 : 128);
}

__host__ __device__ constexpr size_t rup(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Bump allocator over the block's dynamic shared memory (128-byte
// aligned pieces, so every 16-byte vector access is aligned).
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
// wraparound; keep iff the top 24 bits as a [0, 1) float, (x >> 8) *
// 2^-24, are >= rate. Both sides are exact in fp32, so the test is the
// integer one (x >> 8) >= ceil(rate * 2^24) = keep_min (keep_threshold),
// the same bits with no conversion per element.
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return static_cast<uint32_t>(ceilf(rate * 16777216.0f));
}

__device__ __forceinline__ bool keep_elem(uint32_t stream, uint32_t qpos,
                                          uint32_t kpos, uint32_t keep_min) {
  uint32_t x = qpos * 0x9E3779B9u + kpos;
  x += stream;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= keep_min;
}

__device__ __forceinline__ uint32_t hash_stream(const int* seed, int bh,
                                                bool drop) {
  return drop ? (static_cast<uint32_t>(seed[0]) ^
                 (static_cast<uint32_t>(bh) * 0x85EBCA6Bu))
              : 0u;
}

// C[M][N] (pitch ldc) = (acc ? C : 0) + op(A) * op(B) in fp32 FMAs (the
// scalar tiles), op(A) M x K and op(B) K x N. A is stored [M][K] (pitch
// lda), or [K][M] when TA; B is stored [K][N], or [N][K] when TB. The
// whole block calls it. C may be in shared or global memory.
template <bool TA, bool TB>
__device__ __forceinline__ void tile_mm(const float* A, int lda,
                                        const float* B, int ldb, float* C,
                                        int ldc, int M, int N, int K,
                                        bool acc) {
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
  if constexpr (!kScalar<T>)  // 2 x (K, V), rows padded to dpad(D) + 8
    return 4 * t * (dpad(D) + 8) * sizeof(T);
  return 3 * rup(t * ldd(D) * sizeof(T)) + rup(t * ls * sizeof(float)) +
         rup(t * ldd(D) * sizeof(float)) + 2 * rup(t * sizeof(float));
}

template <typename T>
size_t dq_smem(int D) {
  constexpr int t = kTile<T>, ls = kLds<T>;
  if constexpr (!kScalar<T>)  // 2 x (K, V); Q and dO land in the second
    return 4 * t * (dpad(D) + 8) * sizeof(T);
  return 4 * rup(t * ldd(D) * sizeof(T)) + 2 * rup(t * ls * sizeof(float)) +
         rup(t * ldd(D) * sizeof(float)) + 2 * rup(t * sizeof(float));
}

// part: the step also writes the dq partial (the sparse fused backward).
template <typename T>
size_t dkv_smem(int D, bool part) {
  constexpr int t = kTile<T>, ls = kLds<T>;
  if constexpr (!kScalar<T>)  // K, V, 2 x (Q, dO, lse, delta), dS^T
    return 6 * t * (dpad(D) + 8) * sizeof(T) + 4 * t * sizeof(float) +
           (part ? t * (t + 8) * sizeof(T) : 0);
  return 4 * rup(t * ldd(D) * sizeof(T)) + 2 * rup(t * ls * sizeof(float)) +
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
  float* dq_ws;          // sparse fused backward: fp32 dq partials
  const int* seed;
  // Layout gate (flash kernels): int32 [nH, nb, nb], nullptr = ungated;
  // element (h, i, j) gates the (q-block i, k-block j) pair of lay_block
  // x lay_block elements.
  const int* layout;
  int lay_nb, lay_block;
  int nH, S, D;
  float scale, rate, inv_keep;
  int causal;
  // The dropout hash's head count and first head (tensor parallelism: a
  // rank's heads hash at their index among all heads); hash_nH 0 = this
  // launch's heads, bh = b*nH + n.
  int hash_nH, hash_h0;
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
  uint32_t stream, keep_min;
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
    const int hb = a.hash_nH > 0
        ? (bh / a.nH) * a.hash_nH + a.hash_h0 + bh % a.nH : bh;
    stream = hash_stream(a.seed, hb, drop);
    keep_min = keep_threshold(a.rate);
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
                                          uint32_t keep_min, bool drop,
                                          int qpos, int kpos, float s,
                                          float dp, float lse, float delta) {
  const bool masked = a.causal && kpos > qpos;
  const float p = masked ? 0.f : expf(s * a.scale - lse);
  float pd = p;
  if (drop) {
    const bool keep = keep_elem(stream, qpos, kpos, keep_min);
    pd = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  return {pd, p * (dp - delta) * a.scale};
}

// cp.async copies of 64-row tiles at pitch DP + 8: thread -> (rows
// r0 + i * kRowStep, 16-byte chunk cc); chunks at or past D are skipped
// (those columns stay zero).
template <typename T, int DP>
struct TileCopy {
  static constexpr int t = 64;
  static constexpr int LD = DP + 8;
  static constexpr int kCpr = DP / 8;
  static constexpr int kRowStep = kThreads / kCpr;
  int r0, cc;
  bool act;
  __device__ void init(int D) {
    cc = threadIdx.x % kCpr;
    r0 = threadIdx.x / kCpr;
    act = cc * 8 < D;
  }
  __device__ __forceinline__ void copy(T* dst, const T* src,
                                       long long stride) const {
    if (!act) return;
#pragma unroll
    for (int i = 0; i < t / kRowStep; ++i)
      tc::cp_async16(dst + (r0 + i * kRowStep) * LD + cc * 8,
                     src + (r0 + i * kRowStep) * stride + cc * 8, true);
  }
  // Zero columns D..DP-1 of n consecutive tiles from base.
  __device__ static void zero_pad(T* base, int n, int D) {
    if (D == DP) return;
    for (int idx = threadIdx.x; idx < n * t * (DP - D); idx += kThreads) {
      const int r = idx / (DP - D);
      base[r * LD + D + (idx - r * (DP - D))] = from_f32<T>(0.f);
    }
  }
};

// --------------------------------------------------------------------- //
// The forward over one q-tile: begin, one step per visited k-tile, end.
//
// bf16/fp16 (FwdTiles): register-resident, the FlashAttention-2 form on
// mma.sync. Each of the four warps owns 16 of the 64 q rows; its Q
// fragments are loaded once with ldmatrix; S = QK^T (m16n8k16, fp32 accumulate)
// stays in registers, the online softmax runs there with quad shuffles,
// exponentials are 2^x on the SFU over scores scaled by log2(e), dropout
// is decided per element from the fragment's (row, column), and
// P is rounded to T in registers and used directly as the A operand of
// PV (the m16n8 accumulator layout is the m16n8k16 A layout). O stays in
// fp32 registers. K and V come through a cp.async double buffer, V read
// with ldmatrix.trans; rows are padded by 16 bytes so ldmatrix is
// conflict-free. The pipeline runs one tile behind the caller: step(kt)
// waits for the previous tile's copies, issues kt's copies into the other
// buffer, then computes the previous tile while they land; end computes
// the last one. One barrier per k-tile; Q lands in the second buffer and
// is read into registers before that buffer is first filled. Only the
// diagonal tile is masked; the dropout and plain softmax are separate
// code paths. DP is the head dim rounded up to 32, 64 or 128: the register
// arrays, the row pitch and the copy mapping (each thread issues its
// tile's 16-byte copies at fixed offsets) are compile-time, and columns
// D..DP-1 of the shared tiles are zero, so no fragment loop has a
// run-time guard (a guard per fragment compiles to a branch per
// ldmatrix + mma pair, which serialises them).
// --------------------------------------------------------------------- //
template <typename T, int DP>
struct FwdTiles {
  static constexpr int t = 64;
  // Row pitch: DP + 8 elements; columns D..DP-1 stay zero (begin), so the
  // fragment loops run over DP with no run-time guard.
  static constexpr int LD = DP + 8;
  T* buf;  // [2 slots][K, V][t][LD]
  TileCopy<T, DP> cp;
  int n, pending;
  float m[2], l[2];  // rows g, g + 8; m in log2 units (score * log2(e))
  float acc[DP / 8][4];
  uint32_t qa[DP / 16][4];

  __device__ FwdTiles(unsigned char* smem, int) {
    buf = reinterpret_cast<T*>(smem);
  }
  __device__ T* slot(int i) { return buf + i * 2 * t * LD; }

  __device__ __forceinline__ void begin(const HeadPtrs<T>& hp, int qt,
                                        int D) {
    cp.init(D);
    TileCopy<T, DP>::zero_pad(buf, 4, D);
    cp.copy(slot(1), hp.q + static_cast<long long>(qt) * t * hp.sS, hp.sS);
    tc::cp_async_commit();
    n = 0;
    pending = -1;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  __device__ __forceinline__ void step(const Args& a, const HeadPtrs<T>& hp,
                                       int qt, int kt) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile n-1 (or Q) landed; tile n-2's readers done
    if (n == 0) {
      const T* qs = slot(1) + warp * 16 * LD;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::ldsm_x4(qa[kk], qs + ((mi & 1) * 8 + r8) * LD + kk * 16 +
                                (mi >> 1) * 8);
    }
    T* dst = slot(n & 1);
    const long long off = static_cast<long long>(kt) * t * hp.sS;
    cp.copy(dst, hp.k + off, hp.sS);
    cp.copy(dst + t * LD, hp.v + off, hp.sS);
    tc::cp_async_commit();
    if (pending >= 0) compute_any(a, hp, qt);
    pending = kt;
    ++n;
  }

  __device__ __forceinline__ void compute_any(const Args& a,
                                              const HeadPtrs<T>& hp, int qt) {
    if (hp.drop)
      compute<true>(a, hp, qt, pending, slot((n - 1) & 1));
    else
      compute<false>(a, hp, qt, pending, slot((n - 1) & 1));
  }

  // Online softmax and PV over k-tile kt staged at ks (V follows it).
  template <bool kDrop>
  __device__ __forceinline__ void compute(const Args& a, const HeadPtrs<T>& hp,
                                          int qt, int kt, const T* ks) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
    const T* vs = ks + t * LD;
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t b[4];
        tc::ldsm_x4(b, ks + (16 * j + (mi >> 1) * 8 + r8) * LD + kk * 16 +
                           (mi & 1) * 8);
        tc::mma16816<T>(sc[2 * j], qa[kk], b[0], b[1]);
        tc::mma16816<T>(sc[2 * j + 1], qa[kk], b[2], b[3]);
      }
    const bool diag = a.causal && kt == qt;
    const float scale2 = a.scale * tc::kLog2e;  // exp(x) = 2^(x log2 e)
    uint32_t pa[4][4];  // P as A fragments, one per 16 keys
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = qt * t + warp * 16 + g + 8 * rr;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[i][2 * rr + e] * scale2;
          if (diag && kt * t + i * 8 + 2 * tig + e > qpos) x = kNegInf;
          sc[i][2 * rr + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = tc::quad_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = tc::exp2_approx(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[i][2 * rr + e];
          float p = x == kNegInf ? 0.f : tc::exp2_approx(x - m_new);
          psum += p;
          if constexpr (kDrop)
            p = keep_elem(hp.stream, qpos, kt * t + i * 8 + 2 * tig + e,
                          hp.keep_min)
                    ? p * a.inv_keep
                    : 0.f;
          pe[e] = p;
        }
        // keys 16j + 2tig (i = 2j) and 16j + 8 + 2tig (i = 2j + 1)
        pa[i >> 1][(i & 1) * 2 + rr] = tc::pack2<T>(pe[0], pe[1]);
      }
      psum = tc::quad_sum(psum);
      m[rr] = m_new;
      l[rr] = l[rr] * alpha + psum;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        acc[i][2 * rr] *= alpha;
        acc[i][2 * rr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, vs + (16 * j + (mi & 1) * 8 + r8) * LD + n2 * 16 +
                             (mi >> 1) * 8);
        tc::mma16816<T>(acc[2 * n2], pa[j], b[0], b[1]);
        tc::mma16816<T>(acc[2 * n2 + 1], pa[j], b[2], b[3]);
      }
  }

  // o = acc / l (0 for a row that saw no key), lse = m + log(l).
  __device__ __forceinline__ void end(const Args& a, const HeadPtrs<T>& hp,
                                      int qt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    tc::cp_async_wait<0>();
    if (pending >= 0) {
      __syncthreads();
      compute_any(a, hp, qt);
    }
    T* o = static_cast<T*>(a.o) + hp.out;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = qt * t + warp * 16 + g + 8 * rr;
      const float lr = l[rr] == 0.f ? 1.f : l[rr];
      const float inv = 1.f / lr;
      T* orow = o + static_cast<long long>(row) * hp.out_stride;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
        if (i * 8 < a.D)
          *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * tig) =
              tc::pack2<T>(acc[i][2 * rr] * inv, acc[i][2 * rr + 1] * inv);
      if (tig == 0)
        hp.lse[row] =
            m[rr] == kNegInf ? kNegInf : m[rr] * tc::kLn2 + logf(lr);
    }
  }
};

// fp32: 32 x 32 tiles of scalar FMAs (no TF32), scores and accumulator
// in shared memory.
template <typename T>
struct FwdTilesScalar {
  T* Qs;
  T* Ks;
  T* Vs;
  float* Ss;
  T* Ps;
  float* acc;
  float* m_s;
  float* l_s;
  __device__ FwdTilesScalar(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Qs = cv.take<T>(t * LD);
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Ss = cv.take<float>(t * LS);
    Ps = reinterpret_cast<T*>(Ss);
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
    tile_mm<false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
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
          p = keep_elem(hp.stream, qpos, kt * t + c, hp.keep_min)
                  ? p * a.inv_keep
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
    tile_mm<false, false>(Ps, LS, Vs, LD, acc, LD, t, D, t, true);
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


// The forward tile of a type: FwdTiles for bf16/fp16, FwdTilesScalar for
// fp32 (DP unused).
template <typename T, int DP>
using FwdOf = std::conditional_t<kScalar<T>, FwdTilesScalar<T>,
                                 FwdTiles<T, DP>>;


// Blocks per SM the forward kernels are compiled for (registers capped
// at 65536 / (128 * this)): 4 up to DP 64, 3 at DP 128.
__host__ __device__ constexpr int fwd_min_blocks(int DP) {
  return DP == 128 ? 3 : 4;
}

// --------------------------------------------------------------------- //
// The backward: dq over one q-tile (DqTiles) and dk, dv over one k-tile
// (DkvTiles); each is begin, one step per visited tile of the other
// axis, end.
//
// bf16/fp16: register-resident, on the forward's primitives. Both replay
// p = exp(s * scale - lse) from the saved lse (2^x on the SFU over
// log2(e)-scaled values), apply the dropout keep of the fragment's
// (qpos, kpos) and form ds = p * (dp - delta) * scale in registers; only
// the diagonal tile is masked, and the dropout and plain forms are two
// code paths. P_drop and dS are rounded to T in registers and become A
// operands directly (the m16n8 C layout is the m16n8k16 A layout). The
// streamed operand comes through a cp.async double buffer with one
// barrier per step, one tile behind the caller (as FwdTiles streams K
// and V); the resident operand is copied once at begin. Columns D..DP-1
// of every shared tile are zero, so no fragment loop has a run-time
// guard. Per step a pass runs over its 64 streamed rows in chunks of NC
// (64; 32 at DP 128, where the fp32 accumulators take 64 registers), so
// the chunk's score and dp tiles stay within the register budget.
//
// DqTiles (the dq role): each of the four warps owns 16 q rows; its Q
// and dO fragments are loaded once; S = Q K^T and dP = dO V^T with K and
// V as non-transposed B operands, then dQ += dS K with K through
// ldmatrix.trans; dQ stays in fp32 registers until end. K and V stream.
//
// DkvTiles (the dk/dv role, key-row orientation): each warp owns 16 keys;
// S^T = K Q^T and dP^T = V dO^T with the warp's K and V rows as A
// fragments (ldmatrix from the resident tiles) and Q and dO as
// non-transposed B operands; lse and delta are per column. Then
// dV += P_drop^T dO and dK += dS^T Q with Q and dO through
// ldmatrix.trans; dK and dV stay in fp32 registers. Q, dO and the
// q-tile's lse and delta stream. With dq_part (the sparse fused
// backward) a step also writes the q-tile's fp32 dq partial dS K: dS^T is
// staged in shared memory as T, and after a barrier each warp multiplies
// 16 of its q rows (A through ldmatrix.trans) by the resident K.
// --------------------------------------------------------------------- //

// Blocks per SM the backward kernels are compiled for (registers capped
// at 65536 / (128 * this)).
__host__ __device__ constexpr int bwd_min_blocks(int DP) { return 2; }

// The row chunk a backward step works on at once.
__host__ __device__ constexpr int bwd_chunk(int DP) {
  return DP == 128 ? 32 : 64;
}

template <typename T, int DP>
struct DqTiles {
  static constexpr int t = 64;
  static constexpr int LD = DP + 8;
  static constexpr int NC = bwd_chunk(DP);  // keys per chunk
  T* buf;  // [2 slots][K, V][t][LD]; Q, dO land in slot 1 (begin)
  TileCopy<T, DP> cp;
  int n, pending;
  float lse2[2], dlt[2];  // rows g, g + 8: lse * log2(e), delta
  float acc[DP / 8][4];   // dQ
  uint32_t qa[DP / 16][4], da[DP / 16][4];  // Q, dO A fragments

  __device__ DqTiles(unsigned char* smem, int) {
    buf = reinterpret_cast<T*>(smem);
  }
  __device__ T* slot(int i) { return buf + i * 2 * t * LD; }

  __device__ __forceinline__ void begin(const HeadPtrs<T>& hp, int qt,
                                        int D) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    cp.init(D);
    TileCopy<T, DP>::zero_pad(buf, 4, D);
    cp.copy(slot(1), hp.q + static_cast<long long>(qt) * t * hp.sS, hp.sS);
    cp.copy(slot(1) + t * LD,
            hp.dout + static_cast<long long>(qt) * t * hp.out_stride,
            hp.out_stride);
    tc::cp_async_commit();
    n = 0;
    pending = -1;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = qt * t + warp * 16 + (lane >> 2) + 8 * rr;
      lse2[rr] = hp.lse[row] * tc::kLog2e;
      dlt[rr] = hp.delta[row];
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  __device__ __forceinline__ void step(const Args& a, const HeadPtrs<T>& hp,
                                       int qt, int kt) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile n-1 (or Q, dO) landed; tile n-2's readers done
    if (n == 0) {
      const T* qs = slot(1) + warp * 16 * LD;
      const int off = ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        tc::ldsm_x4(qa[kk], qs + off + kk * 16);
        tc::ldsm_x4(da[kk], qs + t * LD + off + kk * 16);
      }
    }
    T* dst = slot(n & 1);
    const long long off = static_cast<long long>(kt) * t * hp.sS;
    cp.copy(dst, hp.k + off, hp.sS);
    cp.copy(dst + t * LD, hp.v + off, hp.sS);
    tc::cp_async_commit();
    if (pending >= 0) compute_any(a, hp, qt);
    pending = kt;
    ++n;
  }

  __device__ __forceinline__ void compute_any(const Args& a,
                                              const HeadPtrs<T>& hp, int qt) {
    if (hp.drop)
      compute<true>(a, hp, qt, pending, slot((n - 1) & 1));
    else
      compute<false>(a, hp, qt, pending, slot((n - 1) & 1));
  }

  // dQ += dS K over k-tile kt staged at ks (V follows it).
  template <bool kDrop>
  __device__ __forceinline__ void compute(const Args& a, const HeadPtrs<T>& hp,
                                          int qt, int kt, const T* ks) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
    const T* vs = ks + t * LD;
    const bool diag = a.causal && kt == qt;
    const float scale2 = a.scale * tc::kLog2e;
#pragma unroll
    for (int h = 0; h < t / NC; ++h) {
      float sc[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NC / 16; ++j)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int off = (h * NC + 16 * j + (mi >> 1) * 8 + r8) * LD +
                          kk * 16 + (mi & 1) * 8;
          uint32_t b[4];
          tc::ldsm_x4(b, ks + off);
          tc::mma16816<T>(sc[2 * j], qa[kk], b[0], b[1]);
          tc::mma16816<T>(sc[2 * j + 1], qa[kk], b[2], b[3]);
          tc::ldsm_x4(b, vs + off);
          tc::mma16816<T>(dp[2 * j], da[kk], b[0], b[1]);
          tc::mma16816<T>(dp[2 * j + 1], da[kk], b[2], b[3]);
        }
      uint32_t sa[NC / 16][4];  // dS as A fragments, one per 16 keys
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qpos = qt * t + warp * 16 + g + 8 * rr;
#pragma unroll
        for (int i = 0; i < NC / 8; ++i) {
          float de[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = kt * t + h * NC + i * 8 + 2 * tig + e;
            float p = diag && kpos > qpos
                          ? 0.f
                          : tc::exp2_approx(sc[i][2 * rr + e] * scale2 -
                                            lse2[rr]);
            float d = dp[i][2 * rr + e];
            if constexpr (kDrop)
              d = keep_elem(hp.stream, qpos, kpos, hp.keep_min)
                      ? d * a.inv_keep
                      : 0.f;
            de[e] = p * (d - dlt[rr]) * a.scale;
          }
          sa[i >> 1][(i & 1) * 2 + rr] = tc::pack2<T>(de[0], de[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC / 16; ++j)
#pragma unroll
        for (int n2 = 0; n2 < DP / 16; ++n2) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, ks + (h * NC + 16 * j + (mi & 1) * 8 + r8) * LD +
                               n2 * 16 + (mi >> 1) * 8);
          tc::mma16816<T>(acc[2 * n2], sa[j], b[0], b[1]);
          tc::mma16816<T>(acc[2 * n2 + 1], sa[j], b[2], b[3]);
        }
    }
  }

  __device__ __forceinline__ void end(const Args& a, const HeadPtrs<T>& hp,
                                      int qt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    tc::cp_async_wait<0>();
    if (pending >= 0) {
      __syncthreads();
      compute_any(a, hp, qt);
    }
    T* dq = static_cast<T*>(a.dq) + hp.out;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      T* row = dq + static_cast<long long>(qt * t + warp * 16 + g + 8 * rr) *
                        hp.out_stride;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
        if (i * 8 < a.D)
          *reinterpret_cast<uint32_t*>(row + i * 8 + 2 * tig) =
              tc::pack2<T>(acc[i][2 * rr], acc[i][2 * rr + 1]);
    }
  }
};

template <typename T, int DP>
struct DkvTiles {
  static constexpr int t = 64;
  static constexpr int LD = DP + 8;
  static constexpr int LDS = t + 8;         // pitch of the staged dS^T
  static constexpr int NC = bwd_chunk(DP);  // queries per chunk
  T* ks;     // [t][LD] K, then V
  T* buf;    // [2 slots][Q, dO][t][LD]
  float* ld; // [2 slots][lse, delta][t]
  T* dst;    // [t][LDS] dS^T (dq partials only)
  TileCopy<T, DP> cp;
  int n, pending;
  float* pending_part;
  float dk[DP / 8][4], dv[DP / 8][4];

  __device__ DkvTiles(unsigned char* smem, int) {
    ks = reinterpret_cast<T*>(smem);
    buf = ks + 2 * t * LD;
    ld = reinterpret_cast<float*>(buf + 4 * t * LD);
    dst = reinterpret_cast<T*>(ld + 4 * t);
  }
  __device__ T* slot(int i) { return buf + i * 2 * t * LD; }

  __device__ __forceinline__ void begin(const HeadPtrs<T>& hp, int kt,
                                        int D) {
    cp.init(D);
    TileCopy<T, DP>::zero_pad(ks, 6, D);
    const long long off = static_cast<long long>(kt) * t * hp.sS;
    cp.copy(ks, hp.k + off, hp.sS);
    cp.copy(ks + t * LD, hp.v + off, hp.sS);
    tc::cp_async_commit();
    n = 0;
    pending = -1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  __device__ __forceinline__ void step(const Args& a, const HeadPtrs<T>& hp,
                                       int qt, int kt, float* dq_part) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile n-1 (or K, V) landed; tile n-2's readers done
    T* d = slot(n & 1);
    cp.copy(d, hp.q + static_cast<long long>(qt) * t * hp.sS, hp.sS);
    cp.copy(d + t * LD,
            hp.dout + static_cast<long long>(qt) * t * hp.out_stride,
            hp.out_stride);
    if (threadIdx.x < 32) {  // lse, then delta: 16 x 16 bytes each
      const int c = (threadIdx.x & 15) * 4;
      const float* src = threadIdx.x < 16 ? hp.lse : hp.delta;
      tc::cp_async16(ld + (n & 1) * 2 * t + (threadIdx.x >> 4) * t + c,
                     src + qt * t + c, true);
    }
    tc::cp_async_commit();
    if (pending >= 0) compute_any(a, hp, kt);
    pending = qt;
    pending_part = dq_part;
    ++n;
  }

  __device__ __forceinline__ void compute_any(const Args& a,
                                              const HeadPtrs<T>& hp, int kt) {
    const int s = (n - 1) & 1;
    if (hp.drop)
      compute<true>(a, hp, pending, kt, slot(s), ld + s * 2 * t,
                    pending_part);
    else
      compute<false>(a, hp, pending, kt, slot(s), ld + s * 2 * t,
                     pending_part);
  }

  // dV += P_drop^T dO, dK += dS^T Q over q-tile qt staged at qs (dO
  // follows it; its lse and delta at lsd).
  template <bool kDrop>
  __device__ __forceinline__ void compute(const Args& a, const HeadPtrs<T>& hp,
                                          int qt, int kt, const T* qs,
                                          const float* lsd, float* part) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
    const T* dos = qs + t * LD;
    const T* vs = ks + t * LD;
    const bool diag = a.causal && kt == qt;
    const float scale2 = a.scale * tc::kLog2e;
    const int aoff = (warp * 16 + (mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int h = 0; h < t / NC; ++h) {
      float sc[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ka[4], va[4];
        tc::ldsm_x4(ka, ks + aoff + kk * 16);
        tc::ldsm_x4(va, vs + aoff + kk * 16);
#pragma unroll
        for (int j = 0; j < NC / 16; ++j) {
          const int off = (h * NC + 16 * j + (mi >> 1) * 8 + r8) * LD +
                          kk * 16 + (mi & 1) * 8;
          uint32_t b[4];
          tc::ldsm_x4(b, qs + off);
          tc::mma16816<T>(sc[2 * j], ka, b[0], b[1]);
          tc::mma16816<T>(sc[2 * j + 1], ka, b[2], b[3]);
          tc::ldsm_x4(b, dos + off);
          tc::mma16816<T>(dp[2 * j], va, b[0], b[1]);
          tc::mma16816<T>(dp[2 * j + 1], va, b[2], b[3]);
        }
      }
      uint32_t pa[NC / 16][4], sa[NC / 16][4];  // P_drop^T, dS^T
#pragma unroll
      for (int i = 0; i < NC / 8; ++i) {
        float pe[2][2], de[2][2];  // [rr][e]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = h * NC + i * 8 + 2 * tig + e;  // query in the tile
          const int qpos = qt * t + c;
          const float l2 = lsd[c] * tc::kLog2e, dl = lsd[t + c];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int kpos = kt * t + warp * 16 + g + 8 * rr;
            const float p = diag && kpos > qpos
                                ? 0.f
                                : tc::exp2_approx(sc[i][2 * rr + e] * scale2 -
                                                  l2);
            float pd = p, d = dp[i][2 * rr + e];
            if constexpr (kDrop) {
              const bool keep =
                  keep_elem(hp.stream, qpos, kpos, hp.keep_min);
              pd = keep ? p * a.inv_keep : 0.f;
              d = keep ? d * a.inv_keep : 0.f;
            }
            pe[rr][e] = pd;
            de[rr][e] = p * (d - dl) * a.scale;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          pa[i >> 1][(i & 1) * 2 + rr] = tc::pack2<T>(pe[rr][0], pe[rr][1]);
          sa[i >> 1][(i & 1) * 2 + rr] = tc::pack2<T>(de[rr][0], de[rr][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC / 16; ++j)
#pragma unroll
        for (int n2 = 0; n2 < DP / 16; ++n2) {
          const int off = (h * NC + 16 * j + (mi & 1) * 8 + r8) * LD +
                          n2 * 16 + (mi >> 1) * 8;
          uint32_t b[4];
          tc::ldsm_x4_t(b, dos + off);
          tc::mma16816<T>(dv[2 * n2], pa[j], b[0], b[1]);
          tc::mma16816<T>(dv[2 * n2 + 1], pa[j], b[2], b[3]);
          tc::ldsm_x4_t(b, qs + off);
          tc::mma16816<T>(dk[2 * n2], sa[j], b[0], b[1]);
          tc::mma16816<T>(dk[2 * n2 + 1], sa[j], b[2], b[3]);
        }
      if (part != nullptr)  // stage dS^T: rows are keys
#pragma unroll
        for (int j = 0; j < NC / 16; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(
                dst + (warp * 16 + g + 8 * (r & 1)) * LDS + h * NC + 16 * j +
                8 * (r >> 1) + 2 * tig) = sa[j][r];
    }
    if (part != nullptr) dq_partial(a, part);
  }

  // part[q][d] (fp32, pitch D) = (dS K)[q][d] for the warp's 16 q rows.
  __device__ __forceinline__ void dq_partial(const Args& a, float* part) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
    __syncthreads();  // every warp's dS^T rows are staged
    uint32_t sa[t / 16][4];  // dS A fragments (q x key), 16 keys each
#pragma unroll
    for (int kk = 0; kk < t / 16; ++kk)
      tc::ldsm_x4_t(sa[kk], dst + (kk * 16 + (mi >> 1) * 8 + r8) * LDS +
                                warp * 16 + (mi & 1) * 8);
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      float c[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < t / 16; ++kk) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, ks + (kk * 16 + (mi & 1) * 8 + r8) * LD + n2 * 16 +
                             (mi >> 1) * 8);
        tc::mma16816<T>(c[0], sa[kk], b[0], b[1]);
        tc::mma16816<T>(c[1], sa[kk], b[2], b[3]);
      }
      if (n2 * 16 < a.D)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<float2*>(
                part + (warp * 16 + g + 8 * rr) * a.D + n2 * 16 + 8 * x +
                2 * tig) = make_float2(c[x][2 * rr], c[x][2 * rr + 1]);
    }
  }

  __device__ __forceinline__ void end(const Args& a, const HeadPtrs<T>& hp,
                                      int kt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    tc::cp_async_wait<0>();
    if (pending >= 0) {
      __syncthreads();
      compute_any(a, hp, kt);
    }
    T* dkp = static_cast<T*>(a.dk) + hp.out;
    T* dvp = static_cast<T*>(a.dv) + hp.out;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row =
          static_cast<long long>(kt * t + warp * 16 + g + 8 * rr) *
          hp.out_stride;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
        if (i * 8 < a.D) {
          *reinterpret_cast<uint32_t*>(dkp + row + i * 8 + 2 * tig) =
              tc::pack2<T>(dk[i][2 * rr], dk[i][2 * rr + 1]);
          *reinterpret_cast<uint32_t*>(dvp + row + i * 8 + 2 * tig) =
              tc::pack2<T>(dv[i][2 * rr], dv[i][2 * rr + 1]);
        }
    }
  }
};

// fp32: 32 x 32 tiles of scalar FMAs (no TF32), with the scores, dS and
// the accumulators in shared memory; the per-element step is grad_elem.
// dq over one q-tile.
template <typename T>
struct DqTilesScalar {
  static_assert(kScalar<T>, "the scalar tiles are fp32");
  T* Qs;
  T* dOs;
  T* Ks;
  T* Vs;
  float* Ss;
  float* dPs;
  float* dSs;
  float* dQ;
  float* lse_s;
  float* delta_s;
  __device__ DqTilesScalar(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Qs = cv.take<T>(t * LD);
    dOs = cv.take<T>(t * LD);
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Ss = cv.take<float>(t * LS);
    dPs = cv.take<float>(t * LS);
    dSs = dPs;  // each dS overwrites the dP it was made from
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
    tile_mm<false, true>(Qs, LD, Ks, LD, Ss, LS, t, t, D, false);
    tile_mm<false, true>(dOs, LD, Vs, LD, dPs, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;
      const int c = idx - r * t;
      const Grad g = grad_elem(a, hp.stream, hp.keep_min, hp.drop,
                               qt * t + r, kt * t + c, Ss[r * LS + c],
                               dPs[r * LS + c], lse_s[r], delta_s[r]);
      dSs[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<false, false>(dSs, LS, Ks, LD, dQ, LD, t, D, t, true);
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

// dk, dv over one k-tile (transposed tiles: rows are keys). A step may
// also write the q-tile's dq partial dS K (fp32, [t][D]) to global
// memory (the sparse fused backward).
template <typename T>
struct DkvTilesScalar {
  static_assert(kScalar<T>, "the scalar tiles are fp32");
  T* Ks;
  T* Vs;
  T* Qs;
  T* dOs;
  float* S2;
  float* dP2;
  float* P2d;
  float* dS2;
  float* dK;
  float* dV;
  float* lse_s;
  float* delta_s;
  __device__ DkvTilesScalar(unsigned char* smem, int D) {
    constexpr int t = kTile<T>, LS = kLds<T>;
    const int LD = ldd(D);
    Carve cv{smem};
    Ks = cv.take<T>(t * LD);
    Vs = cv.take<T>(t * LD);
    Qs = cv.take<T>(t * LD);
    dOs = cv.take<T>(t * LD);
    S2 = cv.take<float>(t * LS);
    dP2 = cv.take<float>(t * LS);
    P2d = S2;  // each element overwrites the s and dp it was made from
    dS2 = dP2;
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
    tile_mm<false, true>(Ks, LD, Qs, LD, S2, LS, t, t, D, false);
    tile_mm<false, true>(Vs, LD, dOs, LD, dP2, LS, t, t, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < t * t; idx += blockDim.x) {
      const int r = idx / t;      // key row
      const int c = idx - r * t;  // query column
      const Grad g = grad_elem(a, hp.stream, hp.keep_min, hp.drop,
                               qt * t + c, kt * t + r, S2[r * LS + c],
                               dP2[r * LS + c], lse_s[c], delta_s[c]);
      P2d[r * LS + c] = from_f32<T>(g.pd);
      dS2[r * LS + c] = from_f32<T>(g.ds);
    }
    __syncthreads();
    tile_mm<false, false>(P2d, LS, dOs, LD, dV, LD, t, D, t, true);
    tile_mm<false, false>(dS2, LS, Qs, LD, dK, LD, t, D, t, true);
    if (dq_part != nullptr)
      tile_mm<true, false>(dS2, LS, Ks, LD, dq_part, D, t, D, t, false);
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

// The backward tiles of a type: register-resident for bf16/fp16, scalar
// for fp32 (DP unused).
template <typename T, int DP>
using DqOf = std::conditional_t<kScalar<T>, DqTilesScalar<T>,
                                DqTiles<T, DP>>;
template <typename T, int DP>
using DkvOf = std::conditional_t<kScalar<T>, DkvTilesScalar<T>,
                                 DkvTiles<T, DP>>;

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
