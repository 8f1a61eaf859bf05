// CPU emulation of the CUDA subset that medseg_tpu_torch/csrc/*.cu uses, so
// that tests/test_torch_kernel_sources.py can build the kernel sources with
// g++ and hold them against their plain PyTorch versions without a GPU.
//
// Blocks run one after another; the threads of a block run as std::threads
// and meet at __syncthreads() on a std::barrier, so __shared__ (a static
// array here) is private to the running block.  Dynamic shared memory
// (`extern __shared__`, rewritten by the test to a pointer into
// emu_dynamic_smem) is a per-block buffer of the launch's size, filled with
// garbage so that a read of an unwritten byte shows.  bfloat16 conversions
// round to nearest even, as cuda_bf16.h's intrinsics do.  A source's
// inline-PTX helpers sit behind `#ifndef MEDSEG_CUDA_EMULATION`, and this
// header gives a CPU version of each: the 32 lanes of a warp meet at a
// per-warp barrier and exchange their fragments through a per-warp buffer.
// Launches are rewritten by the test from
// `kernel<<<grid, block, smem, stream>>>(args);` to
// `EmuLaunch(grid, block, smem, stream)([&] { kernel(args); });`.
#pragma once
#define MEDSEG_CUDA_EMULATION 1
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
inline unsigned char* emu_dynamic_smem = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) { return cudaSuccess; }
// A small card: 2 SMs, 2 resident CTAs each, so persistent kernels walk
// several tiles per CTA here.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
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
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16(lo), __float2bfloat16(hi)};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
// Byte n of the result is byte s[4n+3:4n] of the 8 bytes {y, x} (x the
// low four); selectors here never set the sign-replicate bit.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t bytes = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const unsigned k = (s >> (4 * n)) & 7;
    r |= uint32_t((bytes >> (8 * k)) & 0xff) << (8 * n);
  }
  return r;
}
// Per-halfword unsigned maximum.
inline uint32_t __vmaxu2(uint32_t a, uint32_t b) {
  const uint32_t lo = std::max(a & 0xffffu, b & 0xffffu);
  const uint32_t hi = std::max(a >> 16, b >> 16);
  return lo | (hi << 16);
}

// One warp's meeting point: a barrier of its 32 lanes and two fragment
// buffers, used in turn, so one barrier per exchange suffices (a lane
// rewrites a buffer only after every lane has passed the next barrier, that
// is, after every lane has read it).
struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t a[2][32][4];
  uint32_t b[2][32][2];
};
inline std::vector<std::unique_ptr<EmuWarp>>* emu_warps = nullptr;
inline thread_local unsigned emu_exchanges = 0;

inline unsigned emu_thread_rank() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

// The 32 lanes of the calling warp meet (every lane of it must call).
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu_warps)[emu_thread_rank() / 32]->bar.arrive_and_wait();
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with d as C and D:
// lane l holds A rows l/4 and l/4+8 at k = 2(l%4), +1 (a[0], a[1]) and
// +8, +9 (a[2], a[3]); B at k = 2(l%4), +1 (b[0]) and +8, +9 (b[1]) for
// column l/4; C/D at rows l/4 (d[0], d[1]) and l/4+8 (d[2], d[3]),
// columns 2(l%4), +1.  The lower half of each register is the lower k.
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  const unsigned rank = emu_thread_rank();
  const unsigned lane = rank % 32;
  EmuWarp& warp = *(*emu_warps)[rank / 32];
  const unsigned buf = emu_exchanges++ & 1;
  memcpy(warp.a[buf][lane], a, sizeof(a));
  memcpy(warp.b[buf][lane], b, sizeof(b));
  warp.bar.arrive_and_wait();
  auto half = [](uint32_t word, int k) {
    return __uint_as_float(((word >> (16 * (k % 2))) & 0xffffu) << 16);
  };
  auto a_at = [&](int r, int k) {
    return half(warp.a[buf][4 * (r % 8) + (k % 8) / 2][r / 8 + 2 * (k / 8)], k);
  };
  auto b_at = [&](int k, int n) {
    return half(warp.b[buf][4 * n + (k % 8) / 2][k / 8], k);
  };
  for (int i = 0; i < 4; ++i) {
    const int r = lane / 4 + 8 * (i / 2);
    const int n = 2 * (lane % 4) + i % 2;
    float sum = 0.0f;
    for (int k = 0; k < 16; ++k) sum += a_at(r, k) * b_at(k, n);
    d[i] += sum;
  }
}

// cp.async: the copy (or the zeros) lands at once; waiting is a no-op.
inline void cp_async_16(void* smem_dst, const void* gmem_src, bool valid) {
  if (valid)
    memcpy(smem_dst, gmem_src, 16);
  else
    memset(smem_dst, 0, 16);
}
inline void cp_async_wait_all() {}

struct EmuLaunch {
  dim3 grid, block;
  size_t smem;
  EmuLaunch(dim3 g, dim3 b, size_t s = 0, cudaStream_t = nullptr)
      : grid(g), block(b), smem(s) {}
  template <class F>
  void operator()(F body) {
    gridDim = grid;
    blockDim = block;
    const unsigned n = block.x * block.y * block.z;
    std::vector<unsigned char> dynamic(smem + 16);
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          blockIdx = dim3(x, y, z);
          std::fill(dynamic.begin(), dynamic.end(), 0xa5);
          emu_dynamic_smem = dynamic.data();
          std::vector<std::unique_ptr<EmuWarp>> warps;
          for (unsigned i = 0; i < (n + 31) / 32; ++i)
            warps.push_back(std::make_unique<EmuWarp>());
          emu_warps = &warps;
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
