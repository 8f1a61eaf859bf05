// Fused per-sample horizontal flip + brightness/contrast + normalization of
// uint8 NHWC images: the Hopper port of medseg_tpu/ops/pallas/photometric.py:51
// (fused_photometric, body _kernel).
//
// Function.  out[b, y, x, c] = (clip(img[b, y, x', c] * alpha_b
// + beta_b * 255, 0, 255) - mean_c) / std_c, with x' = W-1-x where sample
// b's flip is set and x' = x otherwise; float32 arithmetic, written as
// float32 or bfloat16 (round to nearest even).  mean_c and std_c arrive on
// the 0..255 scale, already rounded to float32 by the wrapper exactly as the
// plain version rounds them.  Its plain PyTorch version is
// medseg_tpu_torch/ops/kernels/photometric.py::fused_photometric_reference;
// every float operation below runs in the same order (the division stays a
// division), and the library is built with -fmad=false, so kernel and plain
// version agree bit for bit.  Null alpha, beta and flip pointers are the
// eval form (x - mean_c)/std_c: alpha = 1, beta = 0 and no flip give the
// same bits, since x*1 + 0 is exact and the clip does nothing on 0..255, so
// that form skips them.
//
// Bound.  Memory: each uint8 input byte read once and each output written
// once.  At B=128, 256x256x3, float32 out: 25.2 MB + 100.7 MB = 125.8 MB,
// 37.6 us at 3.35 TB/s (22.5 us with bfloat16 out); at the eval path's
// B=16, 4.7 us.  The ~16 instructions per value (the IEEE division most of
// them) stay under half of that at the card's issue rate.
//
// Design.  The TPU kernel works on planar float32 planes and flips with an
// anti-identity matmul, because Mosaic has no lane reversal.  Here a thread
// owns a run of 8 pixels of one row (8*C bytes) and reads it with C 8-byte
// loads, where one thread per pixel made C 1-byte loads.  A flipped row
// reads the mirrored run (aligned too, as W is a multiple of 8) and
// reverses the pixel order in registers: the flip is still an index,
// resolved at compile time in one of two unrolled bodies; channels keep
// their order.  A byte becomes a float by one byte permute and one
// subtraction ((2^23 + b) - 2^23, exact), not by a conversion instruction,
// which issues at an eighth of the float32 rate.  The per-sample scalars
// are read once per thread.
//
// Stores.  A lane's 8*C outputs are contiguous, but 16-byte stores straight
// from each lane put the 32 lanes 8*C*sizeof(out) bytes apart or more: each
// store instruction then writes 16 bytes into each of many lines, and on
// the card that ran 3x slower than one thread per pixel (0.30 against
// 0.097 ms at B=128 float32, with 16-pixel runs).  So each lane writes
// its run into its warp's stage in shared memory, and the warp, whose 32
// runs are contiguous in the output, writes the stage out as 512
// contiguous bytes an instruction.
//
// Shape.  A CTA is 4 warps within one sample, so the flip branch is
// uniform across it, with a stage of 4 x 32 runs (14 KB for C=3 float32).
// Runs of 8 pixels beat runs of 16 (16-byte loads, twice the stage) at
// every batch the card was timed at, B=16 to 128: twice the threads hide
// more latency.  Inputs the vector loads cannot take (W not a multiple of
// 8, the images not 8-byte or the output not 16-byte aligned) take a
// scalar path inside the same kernel, pixel by pixel, with the same
// arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRun = 8;  // pixels a thread owns

struct Norm {
  float mean[kMaxChannels];
  float std[kMaxChannels];
};

// Byte k of `word` as a float, exactly: 0x4B0000bb is 2^23 + b.
__device__ __forceinline__ float byte_as_float(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + k)) - 8388608.0f;
}

template <bool AFFINE>
__device__ __forceinline__ float value(float v, float alpha, float beta255,
                                       float mean, float std) {
  if (AFFINE) v = fminf(fmaxf(v * alpha + beta255, 0.0f), 255.0f);
  return (v - mean) / std;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &pair, sizeof(u));
  return u;
}

// 4 float32 or 8 bfloat16 values as one 16-byte chunk.
__device__ __forceinline__ uint4 chunk(const float* y, float) {
  return uint4{__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
               __float_as_uint(y[3])};
}
__device__ __forceinline__ uint4 chunk(const float* y, __nv_bfloat16) {
  return uint4{pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]), pack_bf16x2(y[4], y[5]),
               pack_bf16x2(y[6], y[7])};
}

// A warp's 32 runs of output in shared memory, run by run: a run is
// kChunks 16-byte chunks, padded to an odd stride so that the 8 lanes of a
// quarter-warp, each writing chunk k of its own run, hit 8 different bank
// groups.
template <int C, typename OutT>
struct Stage {
  static constexpr int kChunks = kRun * C * static_cast<int>(sizeof(OutT)) / 16;
  static constexpr int kStride = kChunks + 1;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The vector path's compute: `in` is the source run (8-byte aligned),
// `slot` the lane's run in the warp's stage.  Output pixel i reads source
// pixel kRun-1-i when FLIP is set, i otherwise.
template <int C, bool FLIP, bool AFFINE, typename OutT>
__device__ __forceinline__ void vector_run(const uint8_t* in, uint4* slot, float alpha,
                                           float beta255, const Norm& norm) {
  constexpr int kPerChunk = 16 / sizeof(OutT);
  uint32_t word[2 * C];
  const auto* src = reinterpret_cast<const uint2*>(in);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint2 v = src[i];
    word[2 * i] = v.x;
    word[2 * i + 1] = v.y;
  }
#pragma unroll
  for (int k = 0; k < Stage<C, OutT>::kChunks; ++k) {
    float y[kPerChunk];
#pragma unroll
    for (int e = 0; e < kPerChunk; ++e) {
      const int o = k * kPerChunk + e;
      const int c = o % C;
      const int j = (FLIP ? kRun - 1 - o / C : o / C) * C + c;  // source byte
      y[e] = value<AFFINE>(byte_as_float(word[j / 4], j % 4), alpha, beta255,
                           norm.mean[c], norm.std[c]);
    }
    slot[k] = chunk(y, OutT());
  }
}

// grid: (CTAs per sample, B).  Thread t of sample b owns run t: row
// t / runs_per_row, pixels from (t % runs_per_row) * kRun.  alpha, beta and
// flip are [B] (float32, float32, bool bytes), all null for the eval form
// (AFFINE false).  On the vector path a warp's 32 runs are contiguous in
// the output: each lane computes its run into the warp's stage, and the
// warp writes the stage out, lane l taking chunks l, l + 32, ..., so that
// each store instruction writes 512 contiguous bytes.
template <int C, bool AFFINE, typename OutT>
__global__ void __launch_bounds__(kThreads)
    photometric_kernel(const uint8_t* __restrict__ images, const float* __restrict__ alpha,
                       const float* __restrict__ beta, const uint8_t* __restrict__ flip,
                       OutT* __restrict__ out, int h, int w, int runs_per_row, bool vec,
                       Norm norm) {
  using S = Stage<C, OutT>;
  __shared__ uint4 stage[kWarps * 32 * S::kStride];
  const int lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * kThreads + threadIdx.x - lane;  // the warp's first run
  const int t = t0 + lane;
  const int b = blockIdx.y;
  const int runs = h * runs_per_row;
  if (t0 >= runs) return;  // the whole warp
  float a = 1.0f, beta255 = 0.0f;
  bool flipped = false;
  if (AFFINE) {
    a = alpha[b];
    beta255 = beta[b] * 255.0f;
    flipped = flip[b] != 0;
  }
  const int y = t / runs_per_row;
  const int x0 = (t - y * runs_per_row) * kRun;
  const size_t row = (static_cast<size_t>(b) * h + y) * w;
  if (!vec) {
    for (int x = x0; t < runs && x < x0 + kRun && x < w; ++x) {
      const uint8_t* in = images + (row + (flipped ? w - 1 - x : x)) * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        store(out + (row + x) * C + c,
              value<AFFINE>(static_cast<float>(in[c]), a, beta255, norm.mean[c],
                            norm.std[c]));
    }
    return;
  }
  uint4* slots = stage + (threadIdx.x / 32) * 32 * S::kStride;
  if (t < runs) {
    uint4* slot = slots + lane * S::kStride;
    if (AFFINE && flipped)
      vector_run<C, true, AFFINE, OutT>(images + (row + w - kRun - x0) * C, slot, a,
                                        beta255, norm);
    else
      vector_run<C, false, AFFINE, OutT>(images + (row + x0) * C, slot, a, beta255, norm);
  }
  __syncwarp();
  const int n_chunks = min(32, runs - t0) * S::kChunks;
  auto* dst = reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * runs + t0) * kRun * C);
#pragma unroll
  for (int k = 0; k < S::kChunks; ++k) {
    const int m = 32 * k + lane;
    if (m < n_chunks) dst[m] = slots[m / S::kChunks * S::kStride + m % S::kChunks];
  }
}

template <int C, bool AFFINE, typename OutT>
void launch_kernel(const uint8_t* images, const float* alpha, const float* beta,
                   const uint8_t* flip, void* out, int b, int h, int w, bool vec,
                   const Norm& norm, cudaStream_t stream) {
  const int runs_per_row = (w + kRun - 1) / kRun;
  const dim3 grid((h * runs_per_row + kThreads - 1) / kThreads, b);
  photometric_kernel<C, AFFINE><<<grid, kThreads, 0, stream>>>(
      images, alpha, beta, flip, static_cast<OutT*>(out), h, w, runs_per_row, vec, norm);
}

template <int C>
void launch_channels(const uint8_t* images, const float* alpha, const float* beta,
                     const uint8_t* flip, void* out, bool out_bf16, int b, int h, int w,
                     bool vec, const Norm& norm, cudaStream_t stream) {
  if (alpha == nullptr && out_bf16)
    launch_kernel<C, false, __nv_bfloat16>(images, alpha, beta, flip, out, b, h, w, vec,
                                           norm, stream);
  else if (alpha == nullptr)
    launch_kernel<C, false, float>(images, alpha, beta, flip, out, b, h, w, vec, norm,
                                   stream);
  else if (out_bf16)
    launch_kernel<C, true, __nv_bfloat16>(images, alpha, beta, flip, out, b, h, w, vec,
                                          norm, stream);
  else
    launch_kernel<C, true, float>(images, alpha, beta, flip, out, b, h, w, vec, norm,
                                  stream);
}

}  // namespace

// images: uint8 [B,H,W,C] contiguous; alpha, beta: float32 [B]; flip: bool
// [B] (one byte each), or all three null for the eval form (alpha = 1,
// beta = 0, no flip); out: [B,H,W,C] float32 (out_bf16 == 0) or bfloat16.
// mean/std hold C float32 values on the 0..255 scale.  Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int medseg_fused_photometric_u8(const void* images, const void* alpha,
                                           const void* beta, const void* flip, void* out,
                                           int b, int h, int w, int c, int out_bf16,
                                           const float* mean, const float* std,
                                           void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || c < 1 || c > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((alpha == nullptr) != (beta == nullptr) || (alpha == nullptr) != (flip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(h) * ((w + kRun - 1) / kRun) + kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Norm norm = {};
  for (int ch = 0; ch < c; ++ch) {
    norm.mean[ch] = mean[ch];
    norm.std[ch] = std[ch];
  }
  const bool vec = w % kRun == 0 && reinterpret_cast<uintptr_t>(images) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* img = static_cast<const uint8_t*>(images);
  const auto* a = static_cast<const float*>(alpha);
  const auto* be = static_cast<const float*>(beta);
  const auto* f = static_cast<const uint8_t*>(flip);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_channels<1>(img, a, be, f, out, out_bf16, b, h, w, vec, norm, st); break;
    case 2: launch_channels<2>(img, a, be, f, out, out_bf16, b, h, w, vec, norm, st); break;
    case 3: launch_channels<3>(img, a, be, f, out, out_bf16, b, h, w, vec, norm, st); break;
    default: launch_channels<4>(img, a, be, f, out, out_bf16, b, h, w, vec, norm, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
