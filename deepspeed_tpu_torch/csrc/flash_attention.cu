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
// bh = b*nH + n, the JAX package's _to_bh order; under tensor
// parallelism a rank's heads hash at their index among all heads
// (hash_nH heads, the rank's first at hash_h0).
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
// are 64 x 64 for bf16/fp16 (32 x 32 for fp32). bf16/fp16 tiles are
// register-resident, the FlashAttention-2 form on mma.sync: each of the
// four warps owns 16 rows, scores, P, dS and the fp32 accumulators stay
// in registers (m16n8k16 from ldmatrix fragments), the streamed operand
// comes through a cp.async double buffer with one barrier per tile, and
// only the diagonal tile is masked. fp32 inputs run scalar fp32 FMAs
// (true fp32, no TF32) in shared memory. P and dS are rounded to the
// input type exactly where the TPU kernels round them (before PV, before
// the dq/dk products; l sums the undropped p; a kept element is scaled by
// the fp32 constant 1/(1-rate)). Masked scores are -1e30, as in the TPU
// kernels.
//
// The fused backward (K2c) is one launch with two block roles over a grid
// of (batch x head, 2 x S/64): an even block computes dk, dv of one
// k-tile (the dk/dv pass of K2b), an odd block dq of one q-tile (K2a's
// pass, which replays s and dp: 14*D matmul FLOPs a kept pair where a
// single pass adding dq partials needs 10*D). In return the grid fills
// the card many times over and dq needs no workspace and no second pass
// over a cross-block sum; roles interleave with the heaviest tiles first
// (k-tile 0 and the last q-tile under the causal rule). No kernel uses
// atomics, so two launches on the same inputs give the same bits. No TMA
// and no wgmma yet.
#include "flash_tiles.cuh"

using namespace dstt;
using namespace dstt::flash;

namespace {

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
// The backward's two roles: dq of q-tile qi over its k-tiles, and dk, dv
// of k-tile kj over its q-tiles (only as far as the causal diagonal;
// tile pairs the layout gate closes are skipped).
// --------------------------------------------------------------------- //
template <typename T, int DP>
__device__ __forceinline__ void dq_tile(const Args& a, int bh, int qi,
                                        unsigned char* smem) {
  DqOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, qi, a.D);
  const int nk = a.causal ? qi + 1 : a.S / kTile<T>;
  for (int kj = 0; kj < nk; ++kj)
    if (gate_open<T>(a, bh, qi, kj)) sm.step(a, hp, qi, kj);
  sm.end(a, hp, qi);
}

template <typename T, int DP>
__device__ __forceinline__ void dkv_tile(const Args& a, int bh, int kj,
                                         unsigned char* smem) {
  DkvOf<T, DP> sm(smem, a.D);
  const HeadPtrs<T> hp(a, bh);
  sm.begin(hp, kj, a.D);
  for (int qi = a.causal ? kj : 0; qi < a.S / kTile<T>; ++qi)
    if (gate_open<T>(a, bh, qi, kj)) sm.step(a, hp, qi, kj, nullptr);
  sm.end(a, hp, kj);
}

// K2a: dq, one block per q-tile, long causal rows first.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_tile<T, DP>(a, blockIdx.x, gridDim.y - 1 - blockIdx.y, smem);
}

// K2b: dk and dv, one block per k-tile (k-tile 0 has the most work).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
flash_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_tile<T, DP>(a, blockIdx.x, blockIdx.y, smem);
}

// K2c: both roles in one launch; blockIdx.y even: dk, dv of k-tile y/2,
// odd: dq of q-tile n-1-y/2, so the heaviest tiles of both come first.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(DP))
flash_bwd_fused_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int y = blockIdx.y, n = a.S / kTile<T>;
  if (y & 1)
    dq_tile<T, DP>(a, blockIdx.x, n - 1 - (y >> 1), smem);
  else
    dkv_tile<T, DP>(a, blockIdx.x, y >> 1, smem);
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

// The kernel of `kind` at head-dim register width DP, and its dynamic
// shared memory.
template <typename T, int DP>
void kernel_of(Kind kind, const Args& a, void (*&kern)(Args), size_t& smem) {
  switch (kind) {
    case kFwd:
      kern = flash_fwd_kernel<T, DP>;
      smem = fwd_smem<T>(a.D);
      break;
    case kDq:
      kern = flash_bwd_dq_kernel<T, DP>;
      smem = dq_smem<T>(a.D);
      break;
    case kDkv:
      kern = flash_bwd_dkv_kernel<T, DP>;
      smem = dkv_smem<T>(a.D, false);
      break;
    default: {
      kern = flash_bwd_fused_kernel<T, DP>;
      const size_t dq = dq_smem<T>(a.D), dkv = dkv_smem<T>(a.D, false);
      smem = dq > dkv ? dq : dkv;
      break;
    }
  }
}

template <typename T>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t st) {
  const int nt = a.S / kTile<T>;
  void (*kern)(Args);
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
  if (a.layout != nullptr &&
      (kind == kFused || a.lay_block % kTile<T> != 0 ||
       static_cast<long long>(a.lay_nb) * a.lay_block != a.S))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.nH, kind == kFused ? 2 * nt : nt);
  kern<<<grid, kThreads, smem, st>>>(a);
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
                              float inv_keep, int causal, int hash_nH,
                              int hash_h0, int dtype, void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
  a.hash_nH = hash_nH;
  a.hash_h0 = hash_h0;
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
                                 float inv_keep, int causal, int hash_nH,
                                 int hash_h0, int dtype, void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
  a.hash_nH = hash_nH;
  a.hash_h0 = hash_h0;
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
                                  int hash_nH, int hash_h0, int dtype,
                                  void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, layout, lay_nb, lay_block,
                     nH, S, D, scale, rate, inv_keep, causal);
  a.hash_nH = hash_nH;
  a.hash_h0 = hash_h0;
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
                                    void* dv, const void* seed,
                                    int B, int nH, int S, int D, float scale,
                                    float rate, float inv_keep, int causal,
                                    int hash_nH, int hash_h0, int dtype,
                                    void* stream) {
  Args a = make_args(q, k, v, sB, sS, sH, seed, nullptr, 0, 0, nH, S, D,
                     scale, rate, inv_keep, causal);
  a.hash_nH = hash_nH;
  a.hash_h0 = hash_h0;
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return dispatch(kFused, a, B, dtype, stream);
}
