// Block-sparse flash attention driven by lookup tables (LUTs): only the
// live blocks of a layout are touched.
//
// Replaces (TPU, Pallas), deepspeed_tpu/ops/sparse_flash.py:
//   _sfwd_kernel       (K7)  -> sparse_fwd_kernel
//   _sdq_kernel        (K8b) -> sparse_dq_kernel
//   _sdkv_kernel       (K8c) -> sparse_dkv_kernel
//   _sfused_bwd_kernel (K8a) -> sparse_fused_bwd_kernel, then
//                               sparse_dq_reduce_kernel (the JAX package's
//                               scatter-add of the dq partials by q row)
//
// Inputs. q, k, v are strided [B, S, nH, D] views (as the flash kernels
// read them); o, dout, dq, dk, dv are contiguous [B, S, nH, D]; lse and
// delta fp32 [B*nH, S]. The LUTs are build_flat_luts' (ops/sparse_flash.py)
// for a layout of `block`-element blocks coarsened to qwiden x widen
// super-tiles, read in row-offset (CSR) form: for head h, the row-major
// entries of super-row q2 are row_ptr[h][q2] .. row_ptr[h][q2+1] of
// kid/kmask, the column-major entries of super-column k2 are
// col_ptr[h][k2] .. col_ptr[h][k2+1] of qidT/kmaskT. Bit sq*widen + sk of
// an entry's kmask says whether its sub-block (sq, sk) is live.
//
// Bound on an H100. The work follows the live (q, k) pairs: two matrix
// products forward; backward three for dq and four for dk/dv (each
// replaying s and dp), or five in the fused pass (dk/dv and the dq
// partial), over the pairs that the layout and the causal rule keep. At gpt2-small with 2 x 4096 tokens and the Fixed
// layout (block 128, 192 live blocks a head: 69.3 M kept pairs) the
// forward needs ~18 GFLOP against ~51 MB of q/k/v/o and lse: the
// tensor-core rate bounds it, and each backward kernel likewise.
//
// Design. A CUDA block owns one tile of 64 rows (32 in fp32) of one head:
// a q-tile (forward, dq) walks the live blocks of its super-row, a k-tile
// (dk/dv, fused) the live blocks of its super-column; each live layout
// block is block/64 tiles, walked in order, and a tile wholly above the
// causal diagonal is skipped. The tile steps (online softmax, dq, dk/dv)
// are the flash kernels' (flash_tiles.cuh), so numerics, rounding points,
// the dropout hash and the -1e30 masking are the same; a masked element
// has probability exactly 0, so a row with no kept key gives zeros; the
// forward (K7) runs the flash forward's register-resident tile. The
// fused backward writes each visited (q-tile, k-tile) pair's fp32 dq
// partial to its own slot of a workspace (slots numbered column-major);
// sparse_dq_reduce_kernel then sums a q-tile's slots in k order. No
// atomics: two launches give the same bits. The backward kernels run the
// flash backward's register-resident tiles (bf16/fp16) with no change to
// their LUT walks; the fused pass's dq partial stages dS^T in shared
// memory (DkvTiles). No TMA, no wgmma.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

struct Luts {
  const int* row_ptr;  // [nH, nq2 + 1]
  const int* kid;      // [nH, nnz_stride]
  const int* kmask;
  const int* col_ptr;  // [nH, nk2 + 1]
  const int* qidT;     // [nH, nnzT_stride]
  const int* kmaskT;
  int nnz_stride, nnzT_stride;
  int nq2, nk2;
  int block, widen, qwiden;
  // Fused backward: first dq-partial slot of each (head, k-tile), and per
  // (head, q-tile) the slots of its partials in k order.
  const int* slot_base;  // [nH, S/t]
  const int* rslot_ptr;  // [nH, S/t + 1]
  const int* rslots;     // [nH, rslot_stride]
  int rslot_stride, slots_per_bh;
};

// The live k-tiles of q-tile qt, in order: calls f(kt) for each.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const Args& a, const Luts& L, int h,
                                        int qt, F f) {
  constexpr int t = kTile<T>;
  const int per = L.block / t;
  const int superq = L.block * L.qwiden;
  const int q2 = qt * t / superq;
  const int sq = (qt * t - q2 * superq) / L.block;
  const int* rp = L.row_ptr + h * (L.nq2 + 1);
  const int* kid = L.kid + static_cast<long long>(h) * L.nnz_stride;
  const int* km = L.kmask + static_cast<long long>(h) * L.nnz_stride;
  for (int n = rp[q2]; n < rp[q2 + 1]; ++n) {
    const int k2 = kid[n];
    const int bits = km[n];
    for (int sk = 0; sk < L.widen; ++sk) {
      if (!((bits >> (sq * L.widen + sk)) & 1)) continue;
      for (int u = 0; u < per; ++u) {
        const int kt = (k2 * L.widen + sk) * per + u;
        if (a.causal && kt > qt) break;
        f(kt);
      }
    }
  }
}

// The live q-tiles of k-tile kt, in order: calls f(qt) for each.
template <typename T, typename F>
__device__ __forceinline__ void for_col(const Args& a, const Luts& L, int h,
                                        int kt, F f) {
  constexpr int t = kTile<T>;
  const int per = L.block / t;
  const int superk = L.block * L.widen;
  const int k2 = kt * t / superk;
  const int sk = (kt * t - k2 * superk) / L.block;
  const int* cp = L.col_ptr + h * (L.nk2 + 1);
  const int* qid = L.qidT + static_cast<long long>(h) * L.nnzT_stride;
  const int* km = L.kmaskT + static_cast<long long>(h) * L.nnzT_stride;
  for (int n = cp[k2]; n < cp[k2 + 1]; ++n) {
    const int q2 = qid[n];
    const int bits = km[n];
    for (int sq = 0; sq < L.qwiden; ++sq) {
      if (!((bits >> (sq * L.widen + sk)) & 1)) continue;
      for (int u = 0; u < per; ++u) {
        const int qt = (q2 * L.qwiden + sq) * per + u;
        if (a.causal && qt < kt) continue;
        f(qt);
      }
    }
  }
}

// K7: forward over the live blocks of one q-tile's row.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(DP))
sparse_fwd_kernel(Args a, Luts L) {
  const int qt = blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  FwdOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, qt, a.D);
  for_row<T>(a, L, bh % a.nH, qt, [&](int kt) { sm.step(a, hp, qt, kt); });
  sm.end(a, hp, qt);
}

// K8b: dq over the live blocks of one q-tile's row.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
sparse_dq_kernel(Args a, Luts L) {
  const int qt = blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  DqOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, qt, a.D);
  for_row<T>(a, L, bh % a.nH, qt, [&](int kt) { sm.step(a, hp, qt, kt); });
  sm.end(a, hp, qt);
}

// K8c: dk, dv over the live blocks of one k-tile's column.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
sparse_dkv_kernel(Args a, Luts L) {
  const int kt = blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  DkvOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, kt, a.D);
  for_col<T>(a, L, bh % a.nH, kt,
             [&](int qt) { sm.step(a, hp, qt, kt, nullptr); });
  sm.end(a, hp, kt);
}

// K8a, pass 1: dk, dv as K8c, and each visited pair's dq partial dS^T K
// into its own fp32 slot of the workspace.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
sparse_fused_bwd_kernel(Args a, Luts L) {
  constexpr int t = kTile<T>;
  const int kt = blockIdx.y, bh = blockIdx.x, h = bh % a.nH;
  extern __shared__ __align__(128) unsigned char smem[];
  DkvOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  float* ws = a.dq_ws + static_cast<long long>(bh) * L.slots_per_bh * t * a.D;
  int slot = L.slot_base[h * (a.S / t) + kt];
  sm.begin(hp, kt, a.D);
  for_col<T>(a, L, h, kt, [&](int qt) {
    sm.step(a, hp, qt, kt, ws + static_cast<long long>(slot++) * t * a.D);
  });
  sm.end(a, hp, kt);
}

// K8a, pass 2: dq of one q-tile = the sum of its partials, in k order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_dq_reduce_kernel(Args a, Luts L) {
  constexpr int t = kTile<T>;
  const int qt = blockIdx.y, bh = blockIdx.x, h = bh % a.nH;
  const int D = a.D;
  const Head hd(a, bh);
  const float* ws = a.dq_ws + static_cast<long long>(bh) * L.slots_per_bh *
                                  t * D;
  const int* rp = L.rslot_ptr + h * (a.S / t + 1);
  const int* sl = L.rslots + static_cast<long long>(h) * L.rslot_stride;
  T* dq = static_cast<T*>(a.dq) + hd.out;
  for (int idx = threadIdx.x; idx < t * D; idx += blockDim.x) {
    float s = 0.f;
    for (int j = rp[qt]; j < rp[qt + 1]; ++j)
      s += ws[static_cast<long long>(sl[j]) * t * D + idx];
    const int r = idx / D;
    const int d = idx - r * D;
    dq[static_cast<long long>(qt * t + r) * hd.out_stride + d] =
        from_f32<T>(s);
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

// The kernel of `kind` at head-dim register width DP, and its dynamic
// shared memory.
template <typename T, int DP>
void kernel_of(Kind kind, const Args& a, void (*&kern)(Args, Luts),
               size_t& smem) {
  switch (kind) {
    case kFwd:
      kern = sparse_fwd_kernel<T, DP>;
      smem = fwd_smem<T>(a.D);
      break;
    case kDq:
      kern = sparse_dq_kernel<T, DP>;
      smem = dq_smem<T>(a.D);
      break;
    case kDkv:
      kern = sparse_dkv_kernel<T, DP>;
      smem = dkv_smem<T>(a.D, false);
      break;
    default:
      kern = sparse_fused_bwd_kernel<T, DP>;
      smem = dkv_smem<T>(a.D, true);
      break;
  }
}

template <typename T>
cudaError_t launch(Kind kind, const Args& a, const Luts& L, int B,
                   cudaStream_t st) {
  constexpr int t = kTile<T>;
  if (L.block % t != 0 || a.S % (L.block * L.qwiden) != 0 ||
      a.S % (L.block * L.widen) != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(B * a.nH, a.S / t);
  void (*kern)(Args, Luts);
  size_t smem;
  // DP: the head dim's register width (the fp32 scalar tiles have none)
  if constexpr (kScalar<T>)
    kernel_of<T, 128>(kind, a, kern, smem);
  else if (dpad(a.D) == 128)
    kernel_of<T, 128>(kind, a, kern, smem);
  else if (dpad(a.D) == 64)
    kernel_of<T, 64>(kind, a, kern, smem);
  else
    kernel_of<T, 32>(kind, a, kern, smem);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(a, L);
  e = cudaGetLastError();
  if (e != cudaSuccess || kind != kFused) return e;
  sparse_dq_reduce_kernel<T><<<grid, kThreads, 0, st>>>(a, L);
  return cudaGetLastError();
}

}  // namespace

// One entry point for the four kernels (kind: 0 forward, 1 dq, 2 dk/dv,
// 3 fused backward); operands a kind does not use are null.
extern "C" int dstt_sparse_flash(
    int kind, const void* q, const void* k, const void* v, long long sB,
    long long sS, long long sH, const void* dout, void* lse,
    const void* delta, void* o, void* dq, void* dk, void* dv, void* dq_ws,
    const void* seed, const void* row_ptr, const void* kid,
    const void* kmask, int nnz_stride, const void* col_ptr,
    const void* qidT, const void* kmaskT, int nnzT_stride,
    const void* slot_base, const void* rslot_ptr, const void* rslots,
    int rslot_stride, int slots_per_bh, int block, int widen, int qwiden,
    int B, int nH, int S, int D, float scale, float rate, float inv_keep,
    int causal, int dtype, void* stream) {
  if (B <= 0 || nH <= 0 || S <= 0) return cudaSuccess;
  if (D % 16 != 0 || D < 16 || D > 128 || block <= 0 || widen <= 0 ||
      qwiden <= 0 || qwiden * widen > 31 || kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  if (rate > 0.f && seed == nullptr) return cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.sB = sB;
  a.sS = sS;
  a.sH = sH;
  a.dout = dout;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.o = o;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_ws = static_cast<float*>(dq_ws);
  a.seed = static_cast<const int*>(seed);
  a.nH = nH;
  a.S = S;
  a.D = D;
  a.scale = scale;
  a.rate = rate;
  a.inv_keep = inv_keep;
  a.causal = causal;
  Luts L{};
  L.row_ptr = static_cast<const int*>(row_ptr);
  L.kid = static_cast<const int*>(kid);
  L.kmask = static_cast<const int*>(kmask);
  L.col_ptr = static_cast<const int*>(col_ptr);
  L.qidT = static_cast<const int*>(qidT);
  L.kmaskT = static_cast<const int*>(kmaskT);
  L.nnz_stride = nnz_stride;
  L.nnzT_stride = nnzT_stride;
  L.block = block;
  L.widen = widen;
  L.qwiden = qwiden;
  L.nq2 = S / (block * qwiden);
  L.nk2 = S / (block * widen);
  L.slot_base = static_cast<const int*>(slot_base);
  L.rslot_ptr = static_cast<const int*>(rslot_ptr);
  L.rslots = static_cast<const int*>(rslots);
  L.rslot_stride = rslot_stride;
  L.slots_per_bh = slots_per_bh;
  const Kind kd = static_cast<Kind>(kind);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32:
      e = launch<float>(kd, a, L, B, st);
      break;
    case kBFloat16:
      e = launch<__nv_bfloat16>(kd, a, L, B, st);
      break;
    case kFloat16:
      e = launch<__half>(kd, a, L, B, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
