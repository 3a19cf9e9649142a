// CPU stand-in for cuda_fp16.h: fp16 as its 16 bits, converted through
// the compiler's _Float16 (round to nearest even).
#pragma once
#include "cuda_runtime.h"
struct __half {
  uint16_t x;
};
struct __half2 {
  __half x, y;  // x in the lower half of the 32-bit word
};
inline float __half2float(__half h) {
  _Float16 v;
  std::memcpy(&v, &h.x, 2);
  return static_cast<float>(v);
}
inline __half __float2half_rn(float f) {
  const _Float16 v = static_cast<_Float16>(f);
  __half h;
  std::memcpy(&h.x, &v, 2);
  return h;
}
inline __half2 __floats2half2_rn(float a, float b) {
  return {__float2half_rn(a), __float2half_rn(b)};
}
