// Fused ResNet stem for inference: conv 7x7 stride 2 pad 3 (3 -> 64
// channels, BatchNorm folded into weights and bias) -> ReLU -> max pool 3x3
// stride 2 pad 1, in one pass: the Hopper port of
// medseg_tpu/ops/pallas/stem_kernel.py (stem_conv_pool_pallas, body
// _stem_kernel).
//
// Function.  Input: planar images [B, 3*H, W] (the warp kernel's planar
// layout: row c*H + y of image b is channel c's row y), H and W multiples
// of 4; folded weights [64, 3, 7, 7] and bias [64]; all in one dtype (float32
// or bfloat16).  Output: NHWC [B, H/4, W/4, 64] in that dtype.  Products are
// summed in float32, the bias is added, then ReLU and the pool run in
// float32, and the pooled value is rounded once (bfloat16: to nearest even).
// The conv pads with zeros.  The pool's padding is taken as 0, which is exact
// because every value after ReLU is >= 0 and each window holds at least one
// real value.  The plain PyTorch version is
// medseg_tpu_torch/ops/kernels/stem_kernel.py::stem_conv_pool_reference
// (float32 conv, bias, ReLU, pool); the two differ only in the order of
// the float32 sum.
//
// Design.  The TPU kernel's space-to-4-depth phase planes, paired outputs
// and K=192 padding exist because Mosaic rejects strided slices and
// non-aligned contractions.  Here a CTA computes one tile of 8x8 pooled
// outputs for 32 of the 64 channels of one image:
//   1. it stages the 39x39x3 input patch that the tile's 17x17 conv outputs
//      read (zeros outside the image) and the tile's 147x32 folded weights
//      in shared memory, as float32;
//   2. each thread accumulates 5 conv positions x 8 channels in registers
//      (explicit fmaf; the library's -fmad=false only stops the compiler
//      from contracting a separate multiply and add), reading 8 weights as
//      two 16-byte loads and one broadcast input value per position per tap;
//   3. bias and ReLU go into a 17x17x32 float32 conv tile in shared memory,
//      which reuses the patch and weight space, with the pool's padding row
//      and column set to 0;
//   4. each thread takes the 3x3 stride-2 max for one channel at 8 pooled
//      positions and writes NHWC, a warp covering 32 consecutive channels.
// The 17x17 conv tile of an 8x8 pooled tile overlaps its neighbours by one
// row and column, so 13% of the conv is computed twice.
//
// Bound.  Operations: 147 multiply-adds for each of the B*(H/2)*(W/2)*64
// conv outputs; at B=128, 256x256 that is 39.5 GFLOP, 40 us on the bf16
// tensor cores (989 TFLOP/s).  Bytes: 50.3 MB planar bf16 in + 67.1 MB out =
// 117.4 MB, 35 us at 3.35 TB/s.  This first version runs the conv as float32
// SIMT fmaf, whose floor is 39.5 GFLOP / 67 TFLOP/s = 0.59 ms; tensor-core
// (wgmma) tiles are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOutChannels = 64;
constexpr int kTile = 8;                      // pooled outputs per tile side
constexpr int kConv = 2 * kTile + 1;          // conv outputs per tile side
constexpr int kPatch = 2 * (kConv - 1) + 7;   // input rows/cols per tile: 39
constexpr int kPatchStride = 40;              // padded row of the patch
constexpr int kTaps = 3 * 7 * 7;
constexpr int kPositions = kConv * kConv;     // 289 conv outputs per tile
constexpr int kChannels = 32;                 // output channels per CTA
constexpr int kThreads = 256;
constexpr int kGroupChannels = 8;             // channels per thread in the conv
constexpr int kGroups = kChannels / kGroupChannels;     // 4
constexpr int kPosStride = kThreads / kGroups;          // 64
constexpr int kPosPerThread = (kPositions + kPosStride - 1) / kPosStride;  // 5
constexpr int kPatchFloats = 3 * kPatch * kPatchStride;  // 4680
constexpr int kWeightFloats = kTaps * kChannels;         // 4704
constexpr int kConvFloats = kPositions * kChannels;      // 9248
constexpr int kSmemFloats = kPatchFloats + kWeightFloats;
static_assert(kConvFloats <= kSmemFloats, "conv tile reuses the staging space");
static_assert(kPatchFloats % 4 == 0, "weights need 16-byte alignment");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_conv_pool_kernel(const T* __restrict__ planes, const T* __restrict__ weight,
                      const T* __restrict__ bias, T* __restrict__ out, int h,
                      int w) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* patch = smem;                 // [3][kPatch][kPatchStride]
  float* wts = smem + kPatchFloats;    // [kTaps][kChannels]
  float* conv = smem;                  // [kPositions][kChannels], after the taps

  const int ph = h / 4;
  const int pw = w / 4;
  const int py0 = blockIdx.y * kTile;
  const int px0 = (blockIdx.x >> 1) * kTile;
  const int c0 = (blockIdx.x & 1) * kChannels;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // 1. Stage the patch: input row 4*py0 - 5 + r, column 4*px0 - 5 + s.
  const T* img = planes + static_cast<size_t>(b) * 3 * h * w;
  const int iy0 = 4 * py0 - 5;
  const int ix0 = 4 * px0 - 5;
  for (int i = tid; i < 3 * kPatch * kPatch; i += kThreads) {
    const int ci = i / (kPatch * kPatch);
    const int rem = i - ci * kPatch * kPatch;
    const int r = rem / kPatch;
    const int s = rem - r * kPatch;
    const int iy = iy0 + r;
    const int ix = ix0 + s;
    float v = 0.0f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < w)
      v = to_float(img[(static_cast<size_t>(ci) * h + iy) * w + ix]);
    patch[(ci * kPatch + r) * kPatchStride + s] = v;
  }
  // ... and the weights, transposed to [tap][channel].
  for (int i = tid; i < kTaps * kChannels; i += kThreads) {
    const int c = i / kTaps;
    const int tap = i - c * kTaps;
    wts[tap * kChannels + c] = to_float(weight[(c0 + c) * kTaps + tap]);
  }
  __syncthreads();

  // 2. The conv: positions pg + 64*k (k < 5) x channels 8*group .. +7.
  const int group = tid % kGroups;
  const int pg = tid / kGroups;
  int base[kPosPerThread];
#pragma unroll
  for (int k = 0; k < kPosPerThread; ++k) {
    const int p = min(pg + kPosStride * k, kPositions - 1);
    const int ly = p / kConv;
    const int lx = p - ly * kConv;
    base[k] = 2 * ly * kPatchStride + 2 * lx;
  }
  float acc[kPosPerThread][kGroupChannels] = {};
  for (int ci = 0; ci < 3; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        const int tap = (ci * 7 + ky) * 7 + kx;
        const float4 wa = *reinterpret_cast<const float4*>(
            wts + tap * kChannels + group * kGroupChannels);
        const float4 wb = *reinterpret_cast<const float4*>(
            wts + tap * kChannels + group * kGroupChannels + 4);
        const float* src = patch + (ci * kPatch + ky) * kPatchStride + kx;
#pragma unroll
        for (int k = 0; k < kPosPerThread; ++k) {
          const float v = src[base[k]];
          acc[k][0] = fmaf(v, wa.x, acc[k][0]);
          acc[k][1] = fmaf(v, wa.y, acc[k][1]);
          acc[k][2] = fmaf(v, wa.z, acc[k][2]);
          acc[k][3] = fmaf(v, wa.w, acc[k][3]);
          acc[k][4] = fmaf(v, wb.x, acc[k][4]);
          acc[k][5] = fmaf(v, wb.y, acc[k][5]);
          acc[k][6] = fmaf(v, wb.z, acc[k][6]);
          acc[k][7] = fmaf(v, wb.w, acc[k][7]);
        }
      }
    }
  }
  __syncthreads();  // every read of the patch and weights is done

  // 3. Bias + ReLU into the conv tile; conv row/column -1 is pool padding.
  float bv[kGroupChannels];
#pragma unroll
  for (int j = 0; j < kGroupChannels; ++j)
    bv[j] = to_float(bias[c0 + group * kGroupChannels + j]);
#pragma unroll
  for (int k = 0; k < kPosPerThread; ++k) {
    const int p = pg + kPosStride * k;
    if (p >= kPositions) break;
    const int ly = p / kConv;
    const int lx = p - ly * kConv;
    const bool pad = (py0 == 0 && ly == 0) || (px0 == 0 && lx == 0);
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j) {
      const float v = fmaxf(acc[k][j] + bv[j], 0.0f);
      conv[p * kChannels + group * kGroupChannels + j] = pad ? 0.0f : v;
    }
  }
  __syncthreads();

  // 4. Max pool 3x3 stride 2: pooled (qy, qx) reads conv rows 2qy..2qy+2.
  const int c = tid % kChannels;
  for (int q = tid / kChannels; q < kTile * kTile; q += kThreads / kChannels) {
    const int qy = q / kTile;
    const int qx = q - qy * kTile;
    if (py0 + qy >= ph || px0 + qx >= pw) continue;
    float m = 0.0f;  // every value is >= 0 after ReLU
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, conv[((2 * qy + dy) * kConv + 2 * qx + dx) * kChannels + c]);
    }
    store(out + ((static_cast<size_t>(b) * ph + py0 + qy) * pw + px0 + qx) *
                    kOutChannels + c0 + c,
          m);
  }
}

template <typename T>
void launch_typed(const void* planes, const void* weight, const void* bias,
                  void* out, int b, int h, int w, cudaStream_t stream) {
  const int tiles_y = (h / 4 + kTile - 1) / kTile;
  const int tiles_x = (w / 4 + kTile - 1) / kTile;
  const dim3 grid(tiles_x * (kOutChannels / kChannels), tiles_y, b);
  stem_conv_pool_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(planes), static_cast<const T*>(weight),
      static_cast<const T*>(bias), static_cast<T*>(out), h, w);
}

}  // namespace

// planes: [B, 3*H, W] contiguous; weight: [64, 3, 7, 7] contiguous (BN
// folded); bias: [64]; out: [B, H/4, W/4, 64].  All float32 (bf16 == 0) or
// all bfloat16.  H and W are multiples of 4.  Returns the cudaGetLastError()
// code of the launch (0 on success).
extern "C" int medseg_stem_conv_pool(const void* planes, const void* weight,
                                     const void* bias, void* out, int b, int h,
                                     int w, int bf16, void* stream) {
  if (b < 1 || b > 65535 || h < 4 || w < 4 || h % 4 != 0 || w % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_typed<__nv_bfloat16>(planes, weight, bias, out, b, h, w, st);
  else
    launch_typed<float>(planes, weight, bias, out, b, h, w, st);
  return static_cast<int>(cudaGetLastError());
}
