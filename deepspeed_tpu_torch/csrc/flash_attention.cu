// Flash attention: the forward and its three backward kernels, dense or
// causal, with in-kernel dropout from a position hash.
//
// Replaces (TPU, Pallas), deepspeed_tpu/ops/flash_attention.py:
//   _fwd_kernel       (K1)  -> flash_fwd_kernel
//   _bwd_dq_kernel    (K2a) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel   (K2b) -> flash_bwd_dkv_kernel
//   _bwd_fused_kernel (K2c) -> flash_bwd_fused_kernel
// K1, K2a and K2b also run the layout-gated (block-sparse) mode of the
// TPU kernels: with a layout (int32 [nH, nb, nb], a block of S/nb
// elements a side), a tile pair whose enclosing layout block is 0 is
// skipped. The sparse attention takes that mode for a layout it cannot
// read on the host (a device tensor) or whose lookup tables do not fit;
// the fused K2c takes no layout, as in the JAX package.
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
// Design (the tile steps live in flash_tiles.cuh, shared with the sparse
// kernels). The TPU grid walks k-blocks sequentially and carries the
// softmax state in VMEM scratch; CUDA blocks run in no order, so each
// block owns one q-tile (forward, dq) or one k-tile (dk/dv) and loops
// over the other axis itself, only as far as the causal diagonal. Tiles
// are 64 x 64 for bf16/fp16 (32 x 32 for fp32). The forward (K1) is
// register-resident, the FlashAttention-2 form on mma.sync: each warp
// owns 16 q rows, S, P and O stay in registers (m16n8k16 from ldmatrix
// fragments, fp32 accumulate), K and V come through a cp.async double
// buffer with one barrier per k-tile, and only the diagonal tile is
// masked (FwdTiles). The backward passes stage their tiles in shared
// memory and run the products through nvcuda::wmma m16n16k16; fp32
// inputs run plain fp32 FMAs (true fp32, no TF32) in both directions.
// P and dS are rounded to the input type exactly where the TPU kernels
// round them (before PV, before the dq/dk products; l sums the undropped
// p; a kept element is scaled by the fp32 constant 1/(1-rate)). Masked
// scores are -1e30, as in the TPU kernels. The fused backward runs one
// block per (batch, head): it walks k-tiles outward and q-tiles inward
// from the diagonal, keeps the k-tile's dk/dv in shared memory and adds
// each tile's dq into an fp32 workspace only this block touches, then
// casts it. No kernel uses atomics, so two launches on the same inputs
// give the same bits. No TMA and no wgmma yet.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

constexpr int kFusedThreads = 256;  // fused backward: one block per head

// Whether the layout gate lets the (q-tile qt, k-tile kt) pair of head bh
// run (always, ungated).
template <typename T>
__device__ __forceinline__ bool gate_open(const Args& a, int bh, int qt,
                                          int kt) {
  if (a.layout == nullptr) return true;
  const int per = a.lay_block / kTile<T>;
  const int h = bh % a.nH;
  return a.layout[(static_cast<long long>(h) * a.lay_nb + qt / per) *
                      a.lay_nb + kt / per] != 0;
}

// --------------------------------------------------------------------- //
// K1: forward
// --------------------------------------------------------------------- //
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(DP))
flash_fwd_kernel(Args a) {
  constexpr int t = kTile<T>;
  // Long causal rows first: q-tiles run in reverse launch order.
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  FwdOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, qi, a.D);
  const int nk = a.causal ? qi + 1 : a.S / t;
  for (int kj = 0; kj < nk; ++kj)
    if (gate_open<T>(a, bh, qi, kj)) sm.step(a, hp, qi, kj);
  sm.end(a, hp, qi);
}

// --------------------------------------------------------------------- //
// K2a: dq over q rows
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int t = kTile<T>;
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  DqTiles<T> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, qi, a.D);
  const int nk = a.causal ? qi + 1 : a.S / t;
  for (int kj = 0; kj < nk; ++kj)
    if (gate_open<T>(a, bh, qi, kj)) sm.step(a, hp, qi, kj);
  sm.end(a, hp, qi);
}

// --------------------------------------------------------------------- //
// K2b: dk and dv over k columns (transposed tiles: rows are keys)
// --------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int t = kTile<T>;
  const int kj = blockIdx.y, bh = blockIdx.x;  // k-tile 0 has most work
  extern __shared__ __align__(128) unsigned char smem[];
  DkvTiles<T> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, kj, a.D);
  const int nq = a.S / t;
  for (int qi = a.causal ? kj : 0; qi < nq; ++qi)
    if (gate_open<T>(a, bh, qi, kj)) sm.step(a, hp, qi, kj, nullptr);
  sm.end(a, hp, kj);
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
      // DP: the head dim's register width (the fp32 scalar tile has none)
      if constexpr (kScalar<T>)
        kern = flash_fwd_kernel<T, 128>;
      else
        kern = dpad(a.D) == 128 ? flash_fwd_kernel<T, 128>
               : dpad(a.D) == 64 ? flash_fwd_kernel<T, 64>
                                 : flash_fwd_kernel<T, 32>;
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
  if (a.layout != nullptr &&
      (kind == kFused || a.lay_block % kTile<T> != 0 ||
       static_cast<long long>(a.lay_nb) * a.lay_block != a.S))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
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
               long long sS, long long sH, const void* seed,
               const void* layout, int lay_nb, int lay_block, int nH, int S,
               int D, float scale, float rate, float inv_keep, int causal) {
  Args a{};
  a.layout = static_cast<const int*>(layout);
  a.lay_nb = lay_nb;
  a.lay_block = lay_block;
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
                              void* o, void* lse, const void* seed,
                              const void* layout, int lay_nb, int lay_block,
                              int B, int nH, int S, int D, float scale, float rate,
                              float inv_keep, int causal, int dtype,
                              void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, a, B, dtype, stream);
}

extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 long long sB, long long sS, long long sH,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* seed, const void* layout,
                                 int lay_nb, int lay_block, int B, int nH,
                                 int S,
                                 int D, float scale, float rate,
                                 float inv_keep, int causal, int dtype,
                                 void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
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
                                  void* dk, void* dv, const void* seed,
                                  const void* layout, int lay_nb,
                                  int lay_block, int B, int nH, int S, int D, float scale,
                                  float rate, float inv_keep, int causal,
                                  int dtype, void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
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
  Args a = make_args(q, k, v, sB, sS, sH, seed, nullptr, 0, 0, nH, S, D,
                     scale, rate, inv_keep, causal);
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_ws = static_cast<float*>(dq_ws);
  return dispatch(kFused, a, B, dtype, stream);
}
