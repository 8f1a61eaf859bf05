// CPU emulation of the CUDA subset that medseg_tpu_torch/csrc/*.cu uses, so
// that tests/test_torch_kernel_sources.py can build the kernel sources with
// g++ and hold them against their plain PyTorch versions without a GPU.
//
// Blocks run one after another; the threads of a block run as std::threads
// and meet at __syncthreads() on a std::barrier, so __shared__ (a static
// array here) is private to the running block.  bfloat16 conversions round
// to nearest even, as cuda_bf16.h's intrinsics do.  Launches are rewritten
// by the test from `kernel<<<grid, block, smem, stream>>>(args);` to
// `EmuLaunch(grid, block, smem, stream)([&] { kernel(args); });`.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, blockDim, gridDim;
inline thread_local dim3 threadIdx;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

struct float4 { float x, y, z, w; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
using std::max;
using std::min;

struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if (std::isnan(f)) return {uint16_t(0x7fc0)};
  return {uint16_t((u + 0x7fff + ((u >> 16) & 1)) >> 16)};
}

struct EmuLaunch {
  dim3 grid, block;
  EmuLaunch(dim3 g, dim3 b, size_t = 0, cudaStream_t = nullptr) : grid(g), block(b) {}
  template <class F>
  void operator()(F body) {
    gridDim = grid;
    blockDim = block;
    const unsigned n = block.x * block.y * block.z;
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          blockIdx = dim3(x, y, z);
          std::barrier<> bar(n);
          emu_barrier = &bar;
          std::vector<std::thread> threads;
          for (unsigned t = 0; t < n; ++t)
            threads.emplace_back([&, t] {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              body();
            });
          for (auto& th : threads) th.join();
        }
  }
};
