// Fused per-sample horizontal flip + brightness/contrast + normalization of
// uint8 NHWC images: the Hopper port of medseg_tpu/ops/pallas/photometric.py
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
// version agree bit for bit.  With alpha = 1, beta = 0 and no flip, x*1 + 0
// is exact and the clip does nothing on 0..255, so this is also the eval
// preprocessing (x - mean_c)/std_c.
//
// Design.  The TPU kernel works on planar float32 planes and flips with an
// anti-identity matmul, because Mosaic has no lane reversal.  Here one
// thread reads one pixel's C uint8 values at column x' and writes its C
// outputs: the flip is only an index.
//
// Bound.  Memory: each uint8 input byte read once and each output written
// once.  At B=128, 256x256x3, float32 out: 25.2 MB + 100.7 MB = 125.8 MB,
// 37.6 us at 3.35 TB/s (22.5 us with bfloat16 out).  Seven flops per value
// are far below the card's float32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;

struct Norm {
  float mean[kMaxChannels];
  float std[kMaxChannels];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// scalars: [B, 3] float32 rows (alpha, beta, flip as 0 or 1).
template <int C, typename OutT>
__global__ void photometric_kernel(const uint8_t* __restrict__ images,
                                   const float* __restrict__ scalars,
                                   OutT* __restrict__ out, int h, int w,
                                   Norm norm) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;

  const float alpha = scalars[3 * b];
  const float beta = scalars[3 * b + 1];
  const int src_x = scalars[3 * b + 2] > 0.5f ? w - 1 - x : x;
  const size_t row = (static_cast<size_t>(b) * h + y) * w;
  const uint8_t* in = images + (row + src_x) * C;
  OutT* o = out + (row + x) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    float v = static_cast<float>(in[ch]);
    v = fminf(fmaxf(v * alpha + beta * 255.0f, 0.0f), 255.0f);
    store(o + ch, (v - norm.mean[ch]) / norm.std[ch]);
  }
}

template <int C>
void launch_channels(const uint8_t* images, const float* scalars, void* out,
                     bool out_bf16, int b, int h, int w, const Norm& norm,
                     cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, b);
  if (out_bf16) {
    photometric_kernel<C><<<grid, block, 0, stream>>>(
        images, scalars, static_cast<__nv_bfloat16*>(out), h, w, norm);
  } else {
    photometric_kernel<C><<<grid, block, 0, stream>>>(
        images, scalars, static_cast<float*>(out), h, w, norm);
  }
}

}  // namespace

// images: uint8 [B,H,W,C] contiguous; scalars: float32 [B,3] contiguous
// (alpha, beta, flip); out: [B,H,W,C] float32 (out_bf16 == 0) or bfloat16.
// mean/std hold C float32 values on the 0..255 scale.  Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int medseg_fused_photometric_u8(const void* images,
                                           const void* scalars, void* out,
                                           int b, int h, int w, int c,
                                           int out_bf16, const float* mean,
                                           const float* std, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || c < 1 || c > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  Norm norm = {};
  for (int ch = 0; ch < c; ++ch) {
    norm.mean[ch] = mean[ch];
    norm.std[ch] = std[ch];
  }
  const auto* img = static_cast<const uint8_t*>(images);
  const auto* sc = static_cast<const float*>(scalars);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_channels<1>(img, sc, out, out_bf16, b, h, w, norm, st); break;
    case 2: launch_channels<2>(img, sc, out, out_bf16, b, h, w, norm, st); break;
    case 3: launch_channels<3>(img, sc, out, out_bf16, b, h, w, norm, st); break;
    default: launch_channels<4>(img, sc, out, out_bf16, b, h, w, norm, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
