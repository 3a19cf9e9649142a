// CPU stand-in for the CUDA runtime as the flash sources
// (deepspeed_tpu_torch/csrc/flash_attention.cu, sparse_flash.cu) use it:
// one std::thread per CUDA thread of a block, std::barrier for
// __syncthreads and, per warp, for the warp collectives (shuffles here,
// ldmatrix and mma.sync in mma.cuh). Blocks of a launch run one after
// another. Dynamic shared memory starts filled with 0xCD bytes, so a tile
// that reads memory it never wrote sees garbage. See run_flash.py.
#pragma once
#include <math.h>

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local int emu_tid;  // x + y * blockDim.x
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint4 {
  unsigned x, y, z, w;
};

// One block's barriers, shared memory and per-warp exchange slots.
struct EmuBlock {
  std::barrier<>* bar;
  std::barrier<>* wbar[32];
  unsigned char* smem;
  uint32_t slot[32][32][8];      // [warp][lane][word]
  const void* pslot[32][32];     // [warp][lane] ldmatrix row addresses
};
inline thread_local EmuBlock* emu_blk;

inline unsigned char* emu_smem() { return emu_blk->smem; }
inline int emu_lane() { return emu_tid & 31; }
inline int emu_warp() { return emu_tid >> 5; }
inline void emu_wsync() { emu_blk->wbar[emu_warp()]->arrive_and_wait(); }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int o) {
  uint32_t(*s)[8] = emu_blk->slot[emu_warp()];
  std::memcpy(&s[emu_lane()][0], &v, 4);
  emu_wsync();
  float r;
  std::memcpy(&r, &s[emu_lane() ^ o][0], 4);
  emu_wsync();
  return r;
}

inline size_t __cvta_generic_to_shared(const void*) { return 0; }

// kern<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [=] { kern(args); }).
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, F f) {
  const int threads = block.x * block.y;
  blockDim = block;
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock* blk = new EmuBlock();
      std::barrier<> bar(threads);
      blk->bar = &bar;
      for (int w = 0; w < threads / 32; ++w)
        blk->wbar[w] = new std::barrier<>(32);
      blk->smem =
          static_cast<unsigned char*>(std::aligned_alloc(128, smem + 128));
      std::memset(blk->smem, 0xCD, smem + 128);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=] {
          threadIdx = dim3(t % block.x, t / block.x);
          emu_tid = t;
          blockIdx = dim3(bx, by);
          emu_blk = blk;
          f();
        });
      for (auto& t : ts) t.join();
      for (int w = 0; w < threads / 32; ++w) delete blk->wbar[w];
      std::free(blk->smem);
      delete blk;
    }
}
