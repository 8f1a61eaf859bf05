// Two-pass affine warp of uint8 NHWC images with the fused photometric
// epilogue: the Hopper port of medseg_tpu/ops/pallas/warp_kernel.py
// (warp_affine_pallas, body _warp_kernel).
//
// Function.  The TPU kernel computes warp_affine_fast
// (medseg_tpu/ops/warp_fast.py), a Catmull-Smith factorization of the
// dst->src affine: a horizontal pass A, then a vertical pass B, each a
// bilinear hat sample at the line's mean offset followed by a per-line
// residual shift clipped to +-(MAX_SHIFT-1) and blended by its fraction.
// This kernel computes that same function, not the single-pass warp
// (medseg_tpu/ops/image.py::_warp_one), which differs by up to ~4 gray.
// Its plain PyTorch version is medseg_tpu_torch/ops/warp_fast.py::
// warp_affine_fast; every float operation below runs in the same order, and
// the library is built with -fmad=false so no multiply-add is contracted:
// kernel and plain version agree bit for bit in float32.
//
// Design.  The TPU form (hat matmuls on the MXU, barrel-shifter rolls) exists
// only because the TPU has no fast gathers.  Here it is a direct gather: one
// thread per output pixel computes all C channels.  Pass B's shift picks two
// padded rows, each row's hat has two taps, pass A's shift at each tap picks
// two columns, and each column is a reflect-101 2-tap sample of the source
// row: 16 uint8 taps per channel (4 for nearest), all from one image, which
// fits in L2 (192 KiB at 256x256x3).  Outputs are written NHWC, or planar
// [B, C*H, W] (channel-major rows, the layout the fused stem kernel reads)
// straight from the same thread, float32 or bfloat16 (round to nearest
// even).
//
// Bound.  Memory: each uint8 input byte read once and each output written
// once, in either layout.  At B=128, 256x256, C=3, bf16 out: 25.2 MB +
// 50.3 MB = 75.5 MB, about 23 us at 3.35 TB/s.  The arithmetic (~50 flops
// per tap) is far below the card's rate.  This first version re-reads taps
// through L1/L2 and stores 2 bytes per thread; shared-memory row staging and
// 16-byte stores are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 80;            // ops/warp_fast.py PAD
constexpr float kMaxShift = 64.0f;  // ops/warp_fast.py MAX_SHIFT
constexpr int kMaxChannels = 4;

struct Epilogue {
  float mean[kMaxChannels];
  float std[kMaxChannels];
};

// Per-image constants of the two passes, derived in the kernel from the
// wrapper's [B, 8] float32 row (aa, cc, bb, m11, m12p, m10, alpha, beta).
struct Scalars {
  float aa, bb, m11, m10, off_a, off_b, mid_row, mid_col;
};

__device__ __forceinline__ int reflect101(int j, int n) {
  const int period = 2 * (n - 1);
  const int r = abs(j) % period;
  return min(r, period - r);
}

// Integer part k and fraction f of a per-line shift.
__device__ __forceinline__ void line_shift(float delta, bool nearest, float& k,
                                           float& f) {
  if (nearest) delta = floorf(delta + 0.5f);
  delta = fminf(fmaxf(delta, -(kMaxShift - 1.0f)), kMaxShift - 1.0f);
  k = floorf(delta);
  f = delta - k;
}

// Pass A at padded row j and padded column x_pad, for all C channels.
template <int C, bool NEAREST>
__device__ __forceinline__ void pass_a(const uint8_t* __restrict__ img, int h,
                                       int w, float j, float x_pad,
                                       const Scalars& s, float out[C]) {
  float ka, fa;
  line_shift(s.bb * (j - s.mid_row) / s.aa, NEAREST, ka, fa);
  const uint8_t* row =
      img + static_cast<size_t>(reflect101(static_cast<int>(j) - kPad, h)) * w * C;
  if (NEAREST) {
    const float src = s.aa * (x_pad + ka) + s.off_a;
    const int col = reflect101(static_cast<int>(floorf(src + 0.5f)) - kPad, w);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[ch] = static_cast<float>(row[col * C + ch]);
    return;
  }
  float shifted[2][C];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float src = s.aa * (x_pad + ka + static_cast<float>(t)) + s.off_a;
    const float j0 = floorf(src);
    const float w0 = 1.0f - (src - j0);
    const float w1 = 1.0f - ((j0 + 1.0f) - src);
    const int c0 = reflect101(static_cast<int>(j0) - kPad, w);
    const int c1 = reflect101(static_cast<int>(j0) + 1 - kPad, w);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      shifted[t][ch] = w0 * static_cast<float>(row[c0 * C + ch]) +
                       w1 * static_cast<float>(row[c1 * C + ch]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    out[ch] = shifted[0][ch] * (1.0f - fa) + shifted[1][ch] * fa;
}

// Pass B's value at padded row v (its hat taps, not reflected; taps outside
// the padded canvas weigh 0), for all C channels.
template <int C, bool NEAREST>
__device__ __forceinline__ void pass_b(const uint8_t* __restrict__ img, int h,
                                       int w, float v, float x_pad,
                                       const Scalars& s, float out[C]) {
  const float hp_last = static_cast<float>(h + 2 * kPad - 1);
  const float src = s.m11 * v + s.off_b;
  if (NEAREST) {
    const float j = floorf(src + 0.5f);
    if (j >= 0.0f && j <= hp_last) {
      pass_a<C, NEAREST>(img, h, w, j, x_pad, s, out);
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) out[ch] = 0.0f;
    }
    return;
  }
  const float j0 = floorf(src);
  const float j1 = j0 + 1.0f;
  const float w0 = 1.0f - (src - j0);
  const float w1 = 1.0f - (j1 - src);
  float p[C], t0[C], t1[C];
  if (j0 >= 0.0f && j0 <= hp_last) {
    pass_a<C, NEAREST>(img, h, w, j0, x_pad, s, p);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t0[ch] = w0 * p[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t0[ch] = 0.0f;
  }
  if (j1 >= 0.0f && j1 <= hp_last) {
    pass_a<C, NEAREST>(img, h, w, j1, x_pad, s, p);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t1[ch] = w1 * p[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t1[ch] = 0.0f;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch] = t0[ch] + t1[ch];
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int C, bool NEAREST, bool EPILOGUE, typename OutT>
__global__ void warp_affine_kernel(const uint8_t* __restrict__ images,
                                   const float* __restrict__ scalars,
                                   OutT* __restrict__ out, int h, int w,
                                   bool planar, Epilogue epi) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;

  const float* sc = scalars + 8 * b;
  Scalars s;
  s.aa = sc[0];
  s.bb = sc[2];
  s.m11 = sc[3];
  s.m10 = sc[5];
  s.mid_row = static_cast<float>(h + 2 * kPad - 1) * 0.5f;
  s.mid_col = static_cast<float>(w + 2 * kPad - 1) * 0.5f;
  s.off_a = sc[1] + s.bb * s.mid_row;
  s.off_b = sc[4] + s.m10 * s.mid_col;

  const uint8_t* img = images + static_cast<size_t>(b) * h * w * C;
  const float x_pad = static_cast<float>(x + kPad);
  const float y_pad = static_cast<float>(y + kPad);

  float kb, fb;
  line_shift(s.m10 * (x_pad - s.mid_col) / s.m11, NEAREST, kb, fb);
  float res[C];
  if (NEAREST) {
    pass_b<C, NEAREST>(img, h, w, y_pad + kb, x_pad, s, res);
  } else {
    float r0[C], r1[C];
    pass_b<C, NEAREST>(img, h, w, y_pad + kb, x_pad, s, r0);
    pass_b<C, NEAREST>(img, h, w, y_pad + kb + 1.0f, x_pad, s, r1);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) res[ch] = r0[ch] * (1.0f - fb) + r1[ch] * fb;
  }

  // NHWC: channel ch at o[ch]; planar: out[b, ch*H + y, x] at o[ch * H*W].
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t pixel = static_cast<size_t>(y) * w + x;
  OutT* o = planar ? out + static_cast<size_t>(b) * C * hw + pixel
                   : out + (static_cast<size_t>(b) * hw + pixel) * C;
  const size_t ch_stride = planar ? hw : 1;
  const float alpha = sc[6];
  const float beta = sc[7];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    float v = res[ch];
    if (EPILOGUE) {
      v = fminf(fmaxf(v * alpha + beta * 255.0f, 0.0f), 255.0f);
      v = (v - epi.mean[ch]) / epi.std[ch];
    }
    store(o + ch * ch_stride, v);
  }
}

template <int C, bool NEAREST, bool EPILOGUE>
void launch_typed(const uint8_t* images, const float* scalars, void* out,
                  bool out_bf16, int b, int h, int w, bool planar,
                  const Epilogue& epi, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, b);
  if (out_bf16) {
    warp_affine_kernel<C, NEAREST, EPILOGUE><<<grid, block, 0, stream>>>(
        images, scalars, static_cast<__nv_bfloat16*>(out), h, w, planar, epi);
  } else {
    warp_affine_kernel<C, NEAREST, EPILOGUE><<<grid, block, 0, stream>>>(
        images, scalars, static_cast<float*>(out), h, w, planar, epi);
  }
}

template <int C>
void launch_channels(const uint8_t* images, const float* scalars, void* out,
                     bool out_bf16, int b, int h, int w, bool nearest,
                     bool epilogue, bool planar, const Epilogue& epi,
                     cudaStream_t stream) {
  if (nearest) {
    if (epilogue)
      launch_typed<C, true, true>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
    else
      launch_typed<C, true, false>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
  } else {
    if (epilogue)
      launch_typed<C, false, true>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
    else
      launch_typed<C, false, false>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
  }
}

}  // namespace

// images: uint8 [B,H,W,C] contiguous; scalars: float32 [B,8] contiguous;
// out: [B,H,W,C], or [B,C*H,W] when planar != 0, float32 (out_bf16 == 0) or
// bfloat16.  mean/std hold C
// values each and are read only when epilogue != 0.  Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int medseg_warp_affine_u8(const void* images, const void* scalars,
                                     void* out, int b, int h, int w, int c,
                                     int nearest, int out_bf16, int epilogue,
                                     int planar, const float* mean,
                                     const float* std, void* stream) {
  if (b < 1 || h < 2 || w < 2 || c < 1 || c > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  Epilogue epi = {};
  if (epilogue) {
    for (int ch = 0; ch < c; ++ch) {
      epi.mean[ch] = mean[ch];
      epi.std[ch] = std[ch];
    }
  }
  const auto* img = static_cast<const uint8_t*>(images);
  const auto* sc = static_cast<const float*>(scalars);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_channels<1>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st); break;
    case 2: launch_channels<2>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st); break;
    case 3: launch_channels<3>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st); break;
    default: launch_channels<4>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
