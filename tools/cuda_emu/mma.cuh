// CPU stand-in for deepspeed_tpu_torch/csrc/mma.cuh with the same
// interface: ldmatrix and mma.sync m16n8k16 exchange each lane's operands
// through the warp's slots in EmuBlock (cuda_runtime.h), with the
// fragment layouts written at the top of the real header; cp.async is a
// plain copy; a product sums its 16 terms in fp32, in k order.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace dstt {
namespace tc {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  if (pred)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
__device__ __forceinline__ void cp_async_commit() {}
template <int N>
__device__ __forceinline__ void cp_async_wait() {}

inline uint16_t emu_h16(const void* row, int col) {
  uint16_t v;
  std::memcpy(&v, static_cast<const char*>(row) + 2 * col, 2);
  return v;
}

// Four 8x8 matrices; lane i gives row i % 8 of matrix i / 8. Lane t gets
// row t / 4, columns 2(t % 4)..+1 of each (trans: of the transpose).
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  const int lane = emu_lane(), w = emu_warp();
  emu_blk->pslot[w][lane] = p;
  emu_wsync();
  const int g = lane >> 2, tig = lane & 3;
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (!trans) {
      const void* row = emu_blk->pslot[w][8 * j + g];
      lo = emu_h16(row, 2 * tig);
      hi = emu_h16(row, 2 * tig + 1);
    } else {
      lo = emu_h16(emu_blk->pslot[w][8 * j + 2 * tig], g);
      hi = emu_h16(emu_blk->pslot[w][8 * j + 2 * tig + 1], g);
    }
    r[j] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  emu_wsync();
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  emu_ldsm(r, p, false);
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  emu_ldsm(r, p, true);
}

template <typename T>
inline float emu_val(uint32_t reg, int half) {
  const uint16_t b = half ? uint16_t(reg >> 16) : uint16_t(reg & 0xffff);
  T h;
  std::memcpy(&h, &b, 2);
  return to_f32(h);
}

// c += a * b: A 16x16 (a0..a3), B 16x8 (b0, b1), C 16x8, lane = 4g + tig.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const int lane = emu_lane(), w = emu_warp();
  uint32_t* s = emu_blk->slot[w][lane];
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0;
  s[5] = b1;
  emu_wsync();
  const int g = lane >> 2, tig = lane & 3;
  float out[4];
  for (int idx = 0; idx < 4; ++idx) {
    const int r = g + 8 * (idx >> 1), n = 2 * tig + (idx & 1);
    float acc = c[idx];
    for (int k = 0; k < 16; ++k) {
      const uint32_t* al = emu_blk->slot[w][4 * (r % 8) + (k % 8) / 2];
      const uint32_t* bl = emu_blk->slot[w][4 * n + (k % 8) / 2];
      acc += emu_val<T>(al[(r >= 8) + 2 * (k >= 8)], k % 2) *
             emu_val<T>(bl[k >= 8 ? 5 : 4], k % 2);
    }
    out[idx] = acc;
  }
  emu_wsync();
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float exp2_approx(float x) { return exp2f(x); }

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tc
}  // namespace dstt
