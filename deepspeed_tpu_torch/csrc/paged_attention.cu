// Table-driven paged attention over the KV block pool: one kernel for
// paged decode (K = 1 query row per stream), speculative verify
// (K = spec_k + 1) and chunked prefill (K = prefill_chunk).
//
// Replaces (TPU, Pallas): deepspeed_tpu/ops/paged_attention.py
//   ::_pattn_kernel (K10), launched by _paged_call / _paged_local.
//
// Layouts (the JAX package's, unchanged):
//   q, out  [GQ, K, nH, D]     GQ = G * Q streams, group-major
//   pool    [G, B, nH, bs, D]  one layer's K (or V) block pool
//   bt      [GQ, J] int32      group-local block ids, < 0 = dead entry
//   pos     [GQ, K] int32      inclusive last attendable position per row
//
// Bound on an H100: memory bytes — the K and V rows of each stream's live
// blocks (attend_hbm_bytes_per_token in ops/paged_attention.py); the
// arithmetic is 4*D flops per (row, key), far below the tensor rate. A
// decode step reads a few MB, so the time is latency: how many SMs pull
// rows at once, and whether the next rows are in flight while these ones
// are used.
//
// Design (flash-decoding). The TPU kernel walks a sequential grid axis j
// over the table and carries the online-softmax state in VMEM. Here the
// grid is (stream, head, split x row group): each block takes 16 query
// rows and an even share of the stream's live table entries, so a decode
// step of 8 streams x 12 heads fills the card instead of 96 blocks on 132
// SMs. The block computes nlive = max(pos) / bs + 1 itself (0 when
// bt[s, 0] < 0, as _paged_local), takes entries [i*nlive/n, (i+1)*nlive/n)
// of split i. It reads those entries' block ids into shared memory once
// (no copy waits on a table load), then walks their keys 64 at a time
// through a 2-3 stage ring of cp.async 16-byte copies (one barrier a
// stage; a key's row is found through the table, so any block size
// works; the pool's type is kept in shared memory). Softmax state is in
// log2 units (scores times log2(e), 2^x on the SFU). Dead entries and keys past the share are zero-filled
// and masked; the mask is inclusive (key t is attended iff t <= pos[k]);
// masked keys contribute exactly 0 (probability set to 0, never derived
// from exp(NEG_INF - m)), so a row whose first live block lies wholly
// past its position cannot pick up weight or NaN.
//   bf16 q (bf16 pool): each of the 4 warps takes 16 of the 64 keys;
//   S = QK^T and PV run on tensor cores (mma.sync m16n8k16 from ldmatrix
//   fragments, V through ldmatrix.trans), the online softmax stays in
//   registers with quad shuffles, and P goes into PV as a bf16 hi + lo
//   pair (two products), so PV keeps the fp32 p of the TPU kernel to
//   about 2^-16. The warps' states merge in warp order at the end.
//   fp32 q (fp32 or bf16 pool): the same split and ring with fp32 FMAs
//   (no TF32), one warp per query row.
// With one split the block writes the output; with more it writes its
// fp32 (m, l, acc) to a workspace that the wrapper allocates, and
// paged_combine_kernel merges the splits in split order. No atomics: two
// launches give the same bits. A stream with no live block writes exact
// zeros. Accumulation is fp32 throughout; only the output rounds to q's
// dtype.
#include "mma.cuh"

using namespace dstt;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // query rows per block (one m16 tile)
constexpr int kKeys = 64;  // keys per stage: 16 per warp

struct Params {
  const void* q;
  const void* pk;
  const void* pv;
  const int* bt;
  const int* pos;
  void* out;
  float* ws;  // nsplit > 1: m [n], l [n], acc [n][D]; n = nsplit*GQ*nH*K
  int GQ, K, nH, Q, B, bs, J, nsplit, row_groups;
  int bs_shift;  // log2(bs) when bs is a power of two, else -1
  int ent;       // table entries a split can hold: ceil(J / nsplit)
  float scale2;  // scale * log2(e): softmax state is kept in log2 units
};

// Ring geometry for a pool type and head dim: rows padded by 16 bytes, so
// ldmatrix over 8 rows touches 8 distinct 16-byte bank groups.
template <typename TKV, int D>
struct Ring {
  static constexpr int kVec = 16 / sizeof(TKV);
  static constexpr int kLd = D + kVec;
  static constexpr int kChunks = D / kVec;  // 16-byte chunks per row
  static constexpr int kStages = D * sizeof(TKV) > 128 ? 2 : 3;
  static constexpr size_t kTile = size_t(kKeys) * kLd * sizeof(TKV);
  static constexpr size_t kBytes = kStages * (2 * kTile + kKeys * 4);
};

// The stream's attended key range [0, kend) and live entry count: the
// table is a dense prefix, so max(pos)/bs + 1 entries (at most J) hold
// attended keys; a dead first entry is a dead stream.
struct Live {
  int nlive, kend;
};
__device__ __forceinline__ Live stream_live(const Params& p, int s) {
  const int* ps = p.pos + static_cast<long long>(s) * p.K;
  int maxpos = -1;
  for (int k = 0; k < p.K; ++k) maxpos = max(maxpos, ps[k]);
  int nlive = maxpos < 0 ? 0 : min(maxpos / p.bs + 1, p.J);
  if (p.bt[static_cast<long long>(s) * p.J] < 0) nlive = 0;
  return {nlive, nlive == 0 ? 0 : min(maxpos + 1, nlive * p.bs)};
}

// Split i's share of the live entries, [b0, b1), and its keys [k0, k1)
// (paged_split_range in ops/paged_attention.py is the same rule). Its
// block ids are staged in shared memory (sblk) before any copy is issued.
struct Share {
  int b0, k0, k1;
};
__device__ __forceinline__ Share split_share(const Params& p, int s, int i,
                                             int* sblk) {
  const Live lv = stream_live(p, s);
  const int b0 = static_cast<int>(static_cast<long long>(i) * lv.nlive /
                                  p.nsplit);
  const int b1 = static_cast<int>(static_cast<long long>(i + 1) * lv.nlive /
                                  p.nsplit);
  const int* bts = p.bt + static_cast<long long>(s) * p.J;
  for (int e = threadIdx.x; e < b1 - b0; e += kThreads) sblk[e] = bts[b0 + e];
  __syncthreads();
  return {b0, b0 * p.bs, min(b1 * p.bs, lv.kend)};
}

// Stage the K and V rows of keys t0 .. t0+63 (those < k1 with a live
// entry; the rest zero-filled) and their live flags into one ring slot.
template <typename TKV, int D>
__device__ __forceinline__ void load_stage(const Params& p, TKV* ks,
                                           int* flags, const int* sblk,
                                           const Share& sh, long long gb,
                                           int h, int t0) {
  using R = Ring<TKV, D>;
  TKV* vs = ks + kKeys * R::kLd;
  const TKV* pk = static_cast<const TKV*>(p.pk);
  const TKV* pv = static_cast<const TKV*>(p.pv);
  for (int c = threadIdx.x; c < kKeys * R::kChunks; c += kThreads) {
    const int r = c / R::kChunks;
    const int ch = c - r * R::kChunks;
    const int t = t0 + r;
    const int j = p.bs_shift >= 0 ? t >> p.bs_shift : t / p.bs;
    const int blk = t < sh.k1 ? sblk[j - sh.b0] : -1;
    const bool ok = blk >= 0;
    long long off = 0;
    if (ok)
      off = ((gb + blk) * p.nH + h) * static_cast<long long>(p.bs) * D +
            static_cast<long long>(t - j * p.bs) * D + ch * R::kVec;
    tc::cp_async16(ks + r * R::kLd + ch * R::kVec, pk + off, ok);
    tc::cp_async16(vs + r * R::kLd + ch * R::kVec, pv + off, ok);
    if (ch == 0) flags[r] = ok;
  }
}

// The final (m, l, acc) of one query row: the output itself with one
// split (o = acc / l, 0 for a row with no key), else the split's partial.
template <typename TQ>
__device__ __forceinline__ void put_row_elem(const Params& p, int s, int h,
                                             int split, int row, int D,
                                             int d, float m, float l,
                                             float acc) {
  if (p.nsplit == 1) {
    TQ* out = static_cast<TQ*>(p.out);
    out[((static_cast<long long>(s) * p.K + row) * p.nH + h) * D + d] =
        from_f32<TQ>(acc / (l == 0.f ? 1.f : l));
    return;
  }
  const long long n = static_cast<long long>(p.nsplit) * p.GQ * p.nH * p.K;
  const long long r =
      ((static_cast<long long>(split) * p.GQ + s) * p.nH + h) * p.K + row;
  if (d == 0) {
    p.ws[r] = m;
    p.ws[n + r] = l;
  }
  p.ws[2 * n + r * D + d] = acc;
}

// --------------------------------------------------------------------- //
// bf16 q over a bf16 pool: tensor cores
// --------------------------------------------------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_mma_kernel(Params p) {
  using R = Ring<T, D>;
  constexpr int LD = R::kLd;
  const int s = blockIdx.x, h = blockIdx.y;
  const int rg = blockIdx.z % p.row_groups;
  const int split = blockIdx.z / p.row_groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* flags = reinterpret_cast<int*>(smem + R::kStages * 2 * R::kTile);
  T* qs = reinterpret_cast<T*>(flags + R::kStages * kKeys);  // [16][LD]
  int* sblk = reinterpret_cast<int*>(qs + kRows * LD);         // [ent]

  const Share sh = split_share(p, s, split, sblk);
  const int ntiles =
      sh.k1 > sh.k0 ? (sh.k1 - sh.k0 + kKeys - 1) / kKeys : 0;
  const long long gb = static_cast<long long>(s / p.Q) * p.B;

  // Q rows of this group (zero past K), in the first copy group.
  const T* q = static_cast<const T*>(p.q);
  for (int c = threadIdx.x; c < kRows * R::kChunks; c += kThreads) {
    const int r = c / R::kChunks;
    const int ch = c - r * R::kChunks;
    const int row = rg * kRows + r;
    const bool ok = row < p.K;
    tc::cp_async16(qs + r * LD + ch * R::kVec,
                   q + (ok ? ((static_cast<long long>(s) * p.K + row) * p.nH +
                              h) * D + ch * R::kVec
                           : 0),
                   ok);
  }
  for (int st = 0; st < R::kStages - 1; ++st) {
    if (st < ntiles)
      load_stage<T, D>(p, ring + st * 2 * kKeys * LD, flags + st * kKeys,
                       sblk, sh, gb, h, sh.k0 + st * kKeys);
    tc::cp_async_commit();
  }

  int posr[2];
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rg * kRows + g + 8 * rr;
    posr[rr] = row < p.K ? p.pos[static_cast<long long>(s) * p.K + row] : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qa[D / 16][4];
  const int kw = warp * 16;  // this warp's keys within a stage

  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<R::kStages - 2>();
    __syncthreads();  // stage it landed; stage it-1's readers are done
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldsm_x4(qa[kk], qs + ((mi & 1) * 8 + r8) * LD + kk * 16 +
                                (mi >> 1) * 8);
    }
    {
      const int nx = it + R::kStages - 1;
      if (nx < ntiles)
        load_stage<T, D>(p, ring + (nx % R::kStages) * 2 * kKeys * LD,
                         flags + (nx % R::kStages) * kKeys, sblk, sh, gb,
                         h, sh.k0 + nx * kKeys);
      tc::cp_async_commit();
    }
    const int slot = it % R::kStages;
    const T* ks = ring + slot * 2 * kKeys * LD;
    const T* vs = ks + kKeys * LD;
    const int* fl = flags + slot * kKeys;
    const int t0 = sh.k0 + it * kKeys;

    // S = Q K^T for this warp's 16 keys: two n8 tiles.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      tc::ldsm_x4(b, ks + (kw + (mi >> 1) * 8 + r8) * LD + kk * 16 +
                         (mi & 1) * 8);
      tc::mma16816<T>(sc[0], qa[kk], b[0], b[1]);
      tc::mma16816<T>(sc[1], qa[kk], b[2], b[3]);
    }

    // Online softmax in registers: rows g (rr 0) and g + 8 (rr 1).
    float pr[2][2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      bool ok[2][2];
      float mx = m[rr];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = kw + nt * 8 + 2 * tig + e;
          ok[nt][e] = fl[kl] != 0 && t0 + kl <= posr[rr];
          if (ok[nt][e]) mx = fmaxf(mx, sc[nt][2 * rr + e] * p.scale2);
        }
      mx = tc::quad_max(mx);
      const float alpha = tc::exp2_approx(m[rr] - mx);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe =
              ok[nt][e] ? tc::exp2_approx(sc[nt][2 * rr + e] * p.scale2 - mx)
                        : 0.f;
          pr[rr][nt][e] = pe;
          psum += pe;
        }
      psum = tc::quad_sum(psum);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = mx;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * rr] *= alpha;
        acc[n][2 * rr + 1] *= alpha;
      }
    }

    // P as a hi + lo pair of A fragments; O += P V.
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int rr = f & 1, nt = f >> 1;
      const float p0 = pr[rr][nt][0], p1 = pr[rr][nt][1];
      ahi[f] = tc::pack2<T>(p0, p1);
      alo[f] = tc::pack2<T>(p0 - tc::round_to<T>(p0),
                            p1 - tc::round_to<T>(p1));
    }
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      tc::ldsm_x4_t(b, vs + (kw + (mi & 1) * 8 + r8) * LD + n2 * 16 +
                           (mi >> 1) * 8);
      tc::mma16816<T>(acc[2 * n2], ahi, b[0], b[1]);
      tc::mma16816<T>(acc[2 * n2], alo, b[0], b[1]);
      tc::mma16816<T>(acc[2 * n2 + 1], ahi, b[2], b[3]);
      tc::mma16816<T>(acc[2 * n2 + 1], alo, b[2], b[3]);
    }
  }

  // Merge the four warps' states in warp order (the ring is free now).
  tc::cp_async_wait<0>();
  __syncthreads();
  constexpr int RL = D + 4;
  float* red = reinterpret_cast<float*>(smem);  // [4][16][RL]
  float* red_m = red + kWarps * kRows * RL;     // [4][16]
  float* red_l = red_m + kWarps * kRows;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* dst = red + (warp * kRows + g + 8 * rr) * RL + n * 8 + 2 * tig;
      dst[0] = acc[n][2 * rr];
      dst[1] = acc[n][2 * rr + 1];
    }
  if (tig == 0)
    for (int rr = 0; rr < 2; ++rr) {
      red_m[warp * kRows + g + 8 * rr] = m[rr];
      red_l[warp * kRows + g + 8 * rr] = l[rr];
    }
  __syncthreads();
  const int rows = min(kRows, p.K - rg * kRows);
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * kRows + r]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = tc::exp2_approx(red_m[w * kRows + r] - M);
      num += e * red[(w * kRows + r) * RL + d];
      den += e * red_l[w * kRows + r];
    }
    put_row_elem<T>(p, s, h, split, rg * kRows + r, D, d, M, den, num);
  }
}

// --------------------------------------------------------------------- //
// fp32 q over an fp32 or bf16 pool: FMAs, one warp per query row
// --------------------------------------------------------------------- //
__device__ __forceinline__ void load4(const float* src, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src,
                                      float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(a);
  f[1] = __high2float(a);
  f[2] = __low2float(b);
  f[3] = __high2float(b);
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_fma_kernel(Params p) {
  using R = Ring<TKV, D>;
  constexpr int LD = R::kLd;
  constexpr int RW = kRows / kWarps;  // rows a warp owns
  constexpr int DL = D / 32;          // output elements a lane owns per row
  const int s = blockIdx.x, h = blockIdx.y;
  const int rg = blockIdx.z % p.row_groups;
  const int split = blockIdx.z / p.row_groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);
  int* flags = reinterpret_cast<int*>(smem + R::kStages * 2 * R::kTile);
  float* qs = reinterpret_cast<float*>(flags + R::kStages * kKeys);  // [16][D]
  float* pbuf = qs + kRows * D;  // [warps][RW][64]
  int* sblk = reinterpret_cast<int*>(pbuf + kRows * kKeys);  // [ent]

  const Share sh = split_share(p, s, split, sblk);
  const int ntiles =
      sh.k1 > sh.k0 ? (sh.k1 - sh.k0 + kKeys - 1) / kKeys : 0;
  const long long gb = static_cast<long long>(s / p.Q) * p.B;

  const float* q = static_cast<const float*>(p.q);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int row = rg * kRows + r;
    qs[i] = row < p.K ? q[((static_cast<long long>(s) * p.K + row) * p.nH +
                           h) * D + (i - r * D)]
                      : 0.f;
  }
  for (int st = 0; st < R::kStages - 1; ++st) {
    if (st < ntiles)
      load_stage<TKV, D>(p, ring + st * 2 * kKeys * LD, flags + st * kKeys,
                         sblk, sh, gb, h, sh.k0 + st * kKeys);
    tc::cp_async_commit();
  }

  int posr[RW];
  float m[RW], l[RW], acc[RW][DL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = rg * kRows + warp + kWarps * i;
    posr[i] = row < p.K ? p.pos[static_cast<long long>(s) * p.K + row] : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<R::kStages - 2>();
    __syncthreads();
    {
      const int nx = it + R::kStages - 1;
      if (nx < ntiles)
        load_stage<TKV, D>(p, ring + (nx % R::kStages) * 2 * kKeys * LD,
                           flags + (nx % R::kStages) * kKeys, sblk, sh,
                           gb, h, sh.k0 + nx * kKeys);
      tc::cp_async_commit();
    }
    const int slot = it % R::kStages;
    const TKV* ks = ring + slot * 2 * kKeys * LD;
    const TKV* vs = ks + kKeys * LD;
    const int* fl = flags + slot * kKeys;
    const int t0 = sh.k0 + it * kKeys;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (posr[i] < t0) continue;  // nothing of this stage is attended
      const int r = warp + kWarps * i;
      const float* qr = qs + r * D;
      float sv[2];
      bool ok[2];
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = lane + 32 * u;
        const TKV* kr = ks + key * LD;
        float a = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          float qv[4], kv[4];
          load4(qr + d, qv);
          load4(kr + d, kv);
          a = fmaf(qv[0], kv[0], a);
          a = fmaf(qv[1], kv[1], a);
          a = fmaf(qv[2], kv[2], a);
          a = fmaf(qv[3], kv[3], a);
        }
        ok[u] = fl[key] != 0 && t0 + key <= posr[i];
        sv[u] = a * p.scale2;
        if (ok[u]) mx = fmaxf(mx, sv[u]);
      }
      mx = warp_max(mx);
      const float alpha = tc::exp2_approx(m[i] - mx);
      const float p0 = ok[0] ? tc::exp2_approx(sv[0] - mx) : 0.f;
      const float p1 = ok[1] ? tc::exp2_approx(sv[1] - mx) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = mx;
      float* pb = pbuf + (warp * RW + i) * kKeys;
      pb[lane] = p0;
      pb[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < DL; ++j) {
        float a = acc[i][j] * alpha;
        for (int t = 0; t < kKeys; ++t)
          a = fmaf(pb[t], to_f32(vs[t * LD + lane + 32 * j]), a);
        acc[i][j] = a;
      }
      __syncwarp();
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = rg * kRows + warp + kWarps * i;
    if (row >= p.K) continue;
#pragma unroll
    for (int j = 0; j < DL; ++j)
      put_row_elem<float>(p, s, h, split, row, D, lane + 32 * j, m[i], l[i],
                          acc[i][j]);
  }
}

// --------------------------------------------------------------------- //
// The splits' partials merged in split order (nsplit > 1)
// --------------------------------------------------------------------- //
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(Params p, int D) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int idx = blockIdx.z * kThreads + threadIdx.x;  // (row, d)
  if (idx >= p.K * D) return;
  const int k = idx / D;
  const int d = idx - k * D;
  const long long n = static_cast<long long>(p.nsplit) * p.GQ * p.nH * p.K;
  const long long step = static_cast<long long>(p.GQ) * p.nH * p.K;
  const long long r0 = (static_cast<long long>(s) * p.nH + h) * p.K + k;
  const float* wm = p.ws;
  const float* wl = p.ws + n;
  const float* wa = p.ws + 2 * n;
  float M = kNegInf;
  for (int i = 0; i < p.nsplit; ++i) M = fmaxf(M, wm[r0 + i * step]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < p.nsplit; ++i) {
    const long long r = r0 + i * step;
    const float e = tc::exp2_approx(wm[r] - M);
    num += e * wa[r * D + d];
    den += e * wl[r];
  }
  static_cast<TQ*>(p.out)[((static_cast<long long>(s) * p.K + k) * p.nH + h) *
                              D + d] =
      from_f32<TQ>(num / (den == 0.f ? 1.f : den));
}

template <typename TQ, typename TKV, int D>
size_t smem_bytes(int ent) {
  using R = Ring<TKV, D>;
  if constexpr (std::is_same<TQ, float>::value) {
    return R::kBytes + kRows * D * 4 + kRows * kKeys * 4 + ent * 4;
  } else {
    const size_t main = R::kBytes + kRows * R::kLd * sizeof(TQ) + ent * 4;
    const size_t red = (kWarps * kRows * (D + 4) + 2 * kWarps * kRows) * 4;
    return main > red ? main : red;
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = smem_bytes<TQ, TKV, D>(p.ent);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  void (*kern)(Params);
  if constexpr (std::is_same<TQ, float>::value)
    kern = paged_attn_fma_kernel<TKV, D>;
  else
    kern = paged_attn_mma_kernel<TQ, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(p.GQ, p.nH, p.nsplit * p.row_groups), kThreads, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.nsplit == 1) return e;
  paged_combine_kernel<TQ>
      <<<dim3(p.GQ, p.nH, (p.K * D + kThreads - 1) / kThreads), kThreads, 0,
         st>>>(p, D);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const Params& p, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(p, st);
    case 64:
      return launch<TQ, TKV, 64>(p, st);
    case 128:
      return launch<TQ, TKV, 128>(p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ws: fp32 workspace of nsplit*GQ*nH*K*(D + 2) floats, unused (may be
// null) when nsplit == 1.
extern "C" int dstt_paged_attention(const void* q, const void* pool_k,
                                    const void* pool_v, const void* bt,
                                    const void* pos, void* out, void* ws,
                                    int GQ, int K, int nH, int D, int G,
                                    int B, int bs, int J, float scale,
                                    int q_dtype, int kv_dtype, int nsplit,
                                    void* stream) {
  if (GQ <= 0 || K <= 0 || nH <= 0) return cudaSuccess;
  if (G <= 0 || GQ % G != 0 || B <= 0 || bs <= 0 || J <= 0 || nsplit <= 0 ||
      (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.pk = pool_k;
  p.pv = pool_v;
  p.bt = static_cast<const int*>(bt);
  p.pos = static_cast<const int*>(pos);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.GQ = GQ;
  p.K = K;
  p.nH = nH;
  p.Q = GQ / G;
  p.B = B;
  p.bs = bs;
  p.J = J;
  p.nsplit = nsplit;
  p.row_groups = (K + kRows - 1) / kRows;
  p.bs_shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  p.ent = (J + nsplit - 1) / nsplit;
  p.scale2 = scale * tc::kLog2e;
  if (static_cast<long long>(nsplit) * p.row_groups > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32) {
    e = launch_d<float, float>(D, p, st);
  } else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16) {
    e = launch_d<__nv_bfloat16, __nv_bfloat16>(D, p, st);
  } else if (q_dtype == kFloat32 && kv_dtype == kBFloat16) {
    e = launch_d<float, __nv_bfloat16>(D, p, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
