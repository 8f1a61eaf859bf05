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
// kernel and plain version agree bit for bit in float32.  Each coordinate is
// computed from its own inputs, never stepped from a neighbour's.
//
// Design.  The TPU form (hat matmuls on the MXU, barrel-shifter rolls) exists
// only because the TPU has no fast gathers.  Pass A's value A(j, x) at padded
// row j and output column x is shared by every output that pass B reads it
// for, so a CTA of 512 threads owns a 64x64 tile of output pixels of one
// image and:
//   1. from the image's scalars, finds the padded rows pass B reads for the
//      tile (pass B's row is monotone in y and its shift kb(x) monotone in
//      x, so the tile's corners bound them), and the source columns pass A
//      reads on those rows (monotone in x and in the row's shift ka);
//   2. stages that window of the source rows those padded rows fold to
//      (reflect-101) in shared memory, at most 384 bytes a row, 16 bytes a
//      load where the row pitch allows, and each row's shift constants
//      (ka, fa: one division per row, not per pixel);
//   3. computes A(j, x) once per (row, column, channel) into shared memory
//      as float32, four adjacent columns a thread (folding columns without
//      a branch when the tile's taps lie within one period of the image);
//   4. runs pass B and the epilogue from 4 shared A values per channel, 8
//      adjacent rows of one column a thread, into an output tile in shared
//      memory that reuses the staging space (NHWC or planar [B, C*H, W],
//      float32 or bfloat16);
//   5. copies the tile out with 16-byte stores, masking the ragged edge.
// A hat sample's coordinate x_pad + ka + t (pass B: y_pad + kb + t) is a sum
// of integers, exact in float32, so column x's sample at t = 1 is column
// x+1's at t = 0, bitwise: five samples give four pass-A values and nine
// give eight pass-B values.  Up to 96 padded rows are staged (a tile at the
// edge of the augmentation envelope, +-15 deg and scale 0.9-1.1, needs at
// most 89).  A row outside the staged range or window, which only matrices
// far outside that envelope produce, is computed by the same pass-A code
// straight from the image in global memory, so any matrix gives the same
// result.
//
// Bound.  Memory: each uint8 input byte read once and each output written
// once, in either layout.  At B=128, 256x256, C=3, bf16 out: 25.2 MB +
// 50.3 MB = 75.5 MB, about 23 us at 3.35 TB/s.  The arithmetic (~16 taps
// and ~40 float operations per output value, ~1.4 pass-A values per output
// at the envelope's edge) is also below the card's rate.  What limits this
// design is latency: its phases (scalars, staging, pass A, pass B with three
// IEEE divisions per pixel, stores) run one after another in a CTA and
// overlap only across the two CTAs on an SM, which the 108.5 KB of shared
// memory a CTA takes allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kPad = 80;            // ops/warp_fast.py PAD
constexpr float kMaxShift = 64.0f;  // ops/warp_fast.py MAX_SHIFT
constexpr int kMaxChannels = 4;
constexpr int kTileW = 64;          // output columns per CTA
constexpr int kTileH = 64;          // output rows per CTA
constexpr int kThreads = 512;
constexpr int kRowCap = 96;         // padded rows staged per CTA, at most
constexpr int kWindowBytes = 384;   // bytes staged per source row, at most
constexpr int kSmemBudget = 200 * 1024;
constexpr int kMaxDevices = 64;

struct Epilogue {
  float mean[kMaxChannels];
  float std[kMaxChannels];
};

// Per-image constants of the two passes, derived in the kernel from the
// wrapper's [B, 8] float32 row (aa, cc, bb, m11, m12p, m10, alpha, beta).
struct Scalars {
  float aa, bb, m11, m10, off_a, off_b, mid_row, mid_col;
};

// Reflect-101 fold of j into [0, n-1], n >= 2: one compare-and-reflect when
// j lies within one period, the general fold otherwise (images smaller than
// the pad).
__device__ __forceinline__ int reflect101(int j, int n) {
  const int last = n - 1;
  int q = j < 0 ? -j : j;
  if (q > last) q = 2 * last - q;
  if (q >= 0) return q;
  const int period = 2 * last;
  const int r = abs(j) % period;
  return min(r, period - r);
}

// The same fold for j in [-(n-1), 2(n-1)], without a branch.
__device__ __forceinline__ int reflect101_near(int j, int n) {
  const int period = 2 * (n - 1);
  const int a = abs(j);
  return min(a, period - a);
}

// Integer part k and fraction f of a per-line shift.
__device__ __forceinline__ void line_shift(float delta, bool nearest, float& k,
                                           float& f) {
  if (nearest) delta = floorf(delta + 0.5f);
  delta = fminf(fmaxf(delta, -(kMaxShift - 1.0f)), kMaxShift - 1.0f);
  k = floorf(delta);
  f = delta - k;
}

// Pass A's shift at padded row j.
__device__ __forceinline__ void row_shift(const Scalars& s, float j,
                                          bool nearest, float& ka, float& fa) {
  line_shift(s.bb * (j - s.mid_row) / s.aa, nearest, ka, fa);
}

// Pass A's hat sample of one source row (already folded) at padded column
// coordinate `coord` (x_pad + ka + t), for all C channels; `row` is in
// shared or global memory.  NEAR: the taps lie within one fold of the image.
template <int C, bool NEAR = false>
__device__ __forceinline__ void hat_sample(const uint8_t* __restrict__ row, int w,
                                           float coord, const Scalars& s,
                                           float out[C]) {
  const float src = s.aa * coord + s.off_a;
  const float j0 = floorf(src);
  const float w0 = 1.0f - (src - j0);
  const float w1 = 1.0f - ((j0 + 1.0f) - src);
  const int q0 = static_cast<int>(j0) - kPad;
  const int c0 = NEAR ? reflect101_near(q0, w) : reflect101(q0, w);
  const int c1 = NEAR ? reflect101_near(q0 + 1, w) : reflect101(q0 + 1, w);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    out[ch] = w0 * static_cast<float>(row[c0 * C + ch]) + w1 * static_cast<float>(row[c1 * C + ch]);
  }
}

template <int C, bool NEAR = false>
__device__ __forceinline__ void nearest_sample(const uint8_t* __restrict__ row, int w,
                                               float coord, const Scalars& s,
                                               float out[C]) {
  const float src = s.aa * coord + s.off_a;
  const int q = static_cast<int>(floorf(src + 0.5f)) - kPad;
  const int col = NEAR ? reflect101_near(q, w) : reflect101(q, w);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch] = static_cast<float>(row[col * C + ch]);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int C>
struct Values {
  float v[C];
};

// Pass A at padded row j and padded column x_pad straight from the image,
// for a row outside the staged range: the staged path's samples and blend.
// Out of line and returning by value, so the hot path keeps its arrays in
// registers.
template <int C, bool NEAREST>
__device__ __noinline__ Values<C> pass_a_from_image(const uint8_t* __restrict__ img,
                                                    int h, int w, float j, float x_pad,
                                                    Scalars s) {
  float ka, fa;
  row_shift(s, j, NEAREST, ka, fa);
  const uint8_t* row =
      img + static_cast<size_t>(reflect101(static_cast<int>(j) - kPad, h)) * w * C;
  Values<C> out;
  if (NEAREST) {
    nearest_sample<C>(row, w, x_pad + ka, s, out.v);
    return out;
  }
  float s0[C], s1[C];
  hat_sample<C>(row, w, x_pad + ka, s, s0);
  hat_sample<C>(row, w, x_pad + ka + 1.0f, s, s1);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out.v[ch] = s0[ch] * (1.0f - fa) + s1[ch] * fa;
  return out;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Bytes between staged source rows: the row rounded up to 16, at most the
// staging width.
__host__ __device__ __forceinline__ int staged_stride(int row_bytes) {
  const int pitch = (row_bytes + 15) & ~15;
  return pitch < kWindowBytes ? pitch : kWindowBytes;
}

// The bytes of dynamic shared memory a launch takes: rows_cap rows of shift
// constants and pass-A values, then the staged source rows, which the
// output tile reuses.
template <int C, typename OutT>
__host__ __device__ __forceinline__ int smem_bytes(int rows_cap, int row_stride) {
  const int staged = rows_cap * row_stride;
  const int tile = kTileH * kTileW * C * static_cast<int>(sizeof(OutT));
  return 2 * kRowCap * 4 + rows_cap * C * kTileW * 4 + (staged > tile ? staged : tile);
}

template <int C, bool NEAREST, bool EPILOGUE, typename OutT>
__global__ void __launch_bounds__(kThreads, C <= 3 ? 2 : 1)
warp_affine_kernel(const uint8_t* __restrict__ images,
                   const float* __restrict__ scalars, OutT* __restrict__ out,
                   int h, int w, bool planar, Epilogue epi, int rows_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* row_ka = reinterpret_cast<float*>(smem);            // [kRowCap]
  float* row_fa = row_ka + kRowCap;                           // [kRowCap]
  float* a_vals = row_fa + kRowCap;                           // [rows][C][kTileW]
  uint8_t* staged = reinterpret_cast<uint8_t*>(a_vals + rows_cap * C * kTileW);
  OutT* tile = reinterpret_cast<OutT*>(staged);  // after pass A

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

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
  const float hp_last = static_cast<float>(h + 2 * kPad - 1);
  const uint8_t* img = images + static_cast<size_t>(b) * h * w * C;
  const int row_bytes = w * C;
  const int row_stride = staged_stride(row_bytes);

  // 1. The padded rows [row0, row0 + nrows) that pass B reads for the tile.
  const int x_last = min(x0 + kTileW, w) - 1;
  const int y_last = min(y0 + kTileH, h) - 1;
  float kb_first, kb_last, unused;
  line_shift(s.m10 * (static_cast<float>(x0 + kPad) - s.mid_col) / s.m11,
             NEAREST, kb_first, unused);
  line_shift(s.m10 * (static_cast<float>(x_last + kPad) - s.mid_col) / s.m11,
             NEAREST, kb_last, unused);
  const float v_lo = static_cast<float>(y0 + kPad) + fminf(kb_first, kb_last);
  const float v_hi = static_cast<float>(y_last + kPad) + fmaxf(kb_first, kb_last) +
                     (NEAREST ? 0.0f : 1.0f);
  const float src_a = s.m11 * v_lo + s.off_b;
  const float src_b = s.m11 * v_hi + s.off_b;
  const float half = NEAREST ? 0.5f : 0.0f;
  const float j_lo = fmaxf(floorf(fminf(src_a, src_b) + half), 0.0f);
  const float j_hi = fminf(floorf(fmaxf(src_a, src_b) + half) + (NEAREST ? 0.0f : 1.0f),
                           hp_last);
  const int row0 = static_cast<int>(j_lo);
  int nrows = j_hi >= j_lo ? min(static_cast<int>(j_hi - j_lo) + 1, rows_cap) : 0;

  // ... and the source columns pass A reads on those rows, as a byte range
  // [lo_b, hi_b) of each folded source row: its coordinate is monotone in
  // the column and in ka, and ka in the row.  A range that crosses an edge
  // of the image covers the columns it folds to.  Rows whose range exceeds
  // the staging width are left to the direct path too.
  const bool wide_rows = row_bytes % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(images) % 16 == 0;
  int lo_b = 0;
  int hi_b = row_bytes;
  bool cols_near = false;  // every pass-A tap lies within one fold of the image
  if (nrows > 0) {
    float ka_first, ka_last;
    row_shift(s, static_cast<float>(row0), NEAREST, ka_first, unused);
    row_shift(s, static_cast<float>(row0 + nrows - 1), NEAREST, ka_last, unused);
    const float coord_lo = static_cast<float>(x0 + kPad) + fminf(ka_first, ka_last);
    const float coord_hi =
        static_cast<float>(x0 + kTileW - 1 + kPad) + fmaxf(ka_first, ka_last) + 1.0f;
    const float sa = s.aa * coord_lo + s.off_a;
    const float sb = s.aa * coord_hi + s.off_a;
    const float q_lo = floorf(fminf(sa, sb)) - static_cast<float>(kPad);
    const float q_hi = floorf(fmaxf(sa, sb)) + 1.0f - static_cast<float>(kPad);
    const int last = w - 1;
    int lo = 0;
    int hi = last;
    cols_near = q_lo >= static_cast<float>(-last) && q_hi <= static_cast<float>(2 * last);
    if (cols_near) {
      const int a = static_cast<int>(q_lo);
      const int z = static_cast<int>(q_hi);
      if (a >= 0 && z <= last) {
        lo = a;
        hi = z;
      } else if (a < 0 && z <= last) {
        hi = max(-a, z);
      } else if (a >= 0) {
        lo = min(a, 2 * last - z);
      }
    }
    lo_b = lo * C;
    hi_b = (hi + 1) * C;
    if (wide_rows) {
      lo_b &= ~15;
      hi_b = min((hi_b + 15) & ~15, row_bytes);
    }
    if (hi_b - lo_b > row_stride) nrows = 0;
  }

  // 2. Each staged row's shift constants and its folded source row's range.
  for (int r = tid; r < nrows; r += kThreads)
    row_shift(s, static_cast<float>(row0 + r), NEAREST, row_ka[r], row_fa[r]);
  if (wide_rows) {
    const int units = (hi_b - lo_b) / 16;
    for (int i = tid; i < nrows * units; i += kThreads) {
      const int r = i / units;
      const int u = i - r * units;
      const int src_row = reflect101(row0 + r - kPad, h);
      *reinterpret_cast<uint4*>(staged + r * row_stride + 16 * u) =
          *reinterpret_cast<const uint4*>(img + static_cast<size_t>(src_row) * row_bytes +
                                          lo_b + 16 * u);
    }
  } else {
    const int n = hi_b - lo_b;
    for (int i = tid; i < nrows * n; i += kThreads) {
      const int r = i / n;
      const int e = i - r * n;
      const int src_row = reflect101(row0 + r - kPad, h);
      staged[r * row_stride + e] = img[static_cast<size_t>(src_row) * row_bytes + lo_b + e];
    }
  }
  __syncthreads();

  // 3. Pass A once per (staged row, tile column, channel), four adjacent
  // columns a thread.  Column x's second hat sample, at x_pad + ka + 1, is
  // column x+1's first, at (x_pad + 1) + ka: both sums are integers, exact
  // in float32, so the two coordinates are the same float and five samples
  // give four values.
  auto pass_a = [&](auto near) {
    constexpr bool kNear = decltype(near)::value;
    constexpr int kQuads = kTileW / 4;
    for (int i = tid; i < nrows * kQuads; i += kThreads) {
      const int r = i / kQuads;
      const int xa = (i - r * kQuads) * 4;
      const uint8_t* row = staged + r * row_stride - lo_b;  // indexed by source byte
      const float ka = row_ka[r];
      const float fa = row_fa[r];
      float v[4][C];
      if (NEAREST) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          nearest_sample<C, kNear>(row, w, static_cast<float>(x0 + xa + k + kPad) + ka, s,
                                   v[k]);
      } else {
        float prev[C], next[C];
        hat_sample<C, kNear>(row, w, static_cast<float>(x0 + xa + kPad) + ka, s, prev);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hat_sample<C, kNear>(row, w, static_cast<float>(x0 + xa + k + 1 + kPad) + ka, s,
                               next);
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            v[k][ch] = prev[ch] * (1.0f - fa) + next[ch] * fa;
            prev[ch] = next[ch];
          }
        }
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float4 q = {v[0][ch], v[1][ch], v[2][ch], v[3][ch]};
        *reinterpret_cast<float4*>(a_vals + (r * C + ch) * kTileW + xa) = q;
      }
    }
  };
  if (cols_near)
    pass_a(Flag<true>());
  else
    pass_a(Flag<false>());
  __syncthreads();  // the staged rows are done with: the output tile reuses them

  // 4. Pass B and the epilogue: a warp takes 32 adjacent columns, a thread
  // 8 adjacent rows of its column.  As in pass A, row y's sample at
  // y_pad + kb + 1 is row y+1's at (y_pad + 1) + kb, so nine samples give
  // eight outputs.
  const int xl = (tid / 32) % 2 * 32 + tid % 32;
  const int yb = tid / 64 * 8;
  const float x_pad = static_cast<float>(x0 + xl + kPad);
  float kb, fb;
  line_shift(s.m10 * (x_pad - s.mid_col) / s.m11, NEAREST, kb, fb);
  const float alpha = sc[6];
  const float beta = sc[7];
  if (x0 + xl < w) {
    // Pass A's value at padded row j (a valid row) and this thread's column.
    auto a_at = [&](float j, float v[C]) {
      const int r = static_cast<int>(j) - row0;
      if (r >= 0 && r < nrows) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[ch] = a_vals[(r * C + ch) * kTileW + xl];
      } else {
        const Values<C> f = pass_a_from_image<C, NEAREST>(img, h, w, j, x_pad, s);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[ch] = f.v[ch];
      }
    };
    // Pass B's sample at padded row coordinate v.
    auto b_sample = [&](float v, float out[C]) {
      const float src = s.m11 * v + s.off_b;
      if (NEAREST) {
        const float j = floorf(src + 0.5f);
        if (j >= 0.0f && j <= hp_last) {
          a_at(j, out);
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
        a_at(j0, p);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) t0[ch] = w0 * p[ch];
      } else {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) t0[ch] = 0.0f;
      }
      if (j1 >= 0.0f && j1 <= hp_last) {
        a_at(j1, p);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) t1[ch] = w1 * p[ch];
      } else {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) t1[ch] = 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) out[ch] = t0[ch] + t1[ch];
    };

    float prev[C], next[C];
    if (!NEAREST) b_sample(static_cast<float>(y0 + yb + kPad) + kb, prev);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float res[C];
      if (NEAREST) {
        b_sample(static_cast<float>(y0 + yb + k + kPad) + kb, res);
      } else {
        b_sample(static_cast<float>(y0 + yb + k + 1 + kPad) + kb, next);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          res[ch] = prev[ch] * (1.0f - fb) + next[ch] * fb;
          prev[ch] = next[ch];
        }
      }
      const int yl = yb + k;
      if (y0 + yl >= h) break;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float v = res[ch];
        if (EPILOGUE) {
          v = fminf(fmaxf(v * alpha + beta * 255.0f, 0.0f), 255.0f);
          v = (v - epi.mean[ch]) / epi.std[ch];
        }
        // NHWC tile: [row][column][channel]; planar tile: [channel][row][column]
        store(tile + (planar ? (ch * kTileH + yl) * kTileW + xl
                             : (yl * kTileW + xl) * C + ch),
              v);
      }
    }
  }
  __syncthreads();

  // 5. Copy the tile out, 16 bytes a store where the row pitch allows; a
  // tile row is one output row (NHWC) or one channel's row (planar).
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(OutT));
  const int cols = x_last - x0 + 1;
  const int row_elems = planar ? cols : cols * C;
  const int tile_row = planar ? kTileW : kTileW * C;
  const int units = tile_row / kPerUnit;
  const int n_rows = planar ? C * kTileH : kTileH;
  const size_t pitch = planar ? static_cast<size_t>(w) : static_cast<size_t>(w) * C;
  const bool wide_out = pitch * sizeof(OutT) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = tid; i < n_rows * units; i += kThreads) {
    const int tr = i / units;
    const int e = (i - tr * units) * kPerUnit;
    const int ch = planar ? tr / kTileH : 0;
    const int y = y0 + (planar ? tr - ch * kTileH : tr);
    if (y >= h || e >= row_elems) continue;
    OutT* dst = out + (static_cast<size_t>(b) * (planar ? C : 1) + ch) * h * pitch +
                static_cast<size_t>(y) * pitch + static_cast<size_t>(x0) * (planar ? 1 : C) + e;
    const OutT* src = tile + tr * tile_row + e;
    if (wide_out && e + kPerUnit <= row_elems) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < kPerUnit && e + k < row_elems; ++k) dst[k] = src[k];
    }
  }
}

template <int C, bool NEAREST, bool EPILOGUE, typename OutT>
int launch_typed(const uint8_t* images, const float* scalars, void* out, int b,
                 int h, int w, bool planar, const Epilogue& epi,
                 cudaStream_t stream) {
  const int row_stride = staged_stride(w * C);
  int rows_cap = kRowCap;
  while (rows_cap > 0 && smem_bytes<C, OutT>(rows_cap, row_stride) > kSmemBudget)
    --rows_cap;
  const int smem = smem_bytes<C, OutT>(rows_cap, row_stride);
  auto* kernel = warp_affine_kernel<C, NEAREST, EPILOGUE, OutT>;
  // The opt-in to the whole budget, once per device: no launch takes more.
  static std::atomic<bool> opted_in[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device < 0 || device >= kMaxDevices))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess && !opted_in[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err == cudaSuccess) opted_in[device].store(true, std::memory_order_release);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  kernel<<<grid, kThreads, smem, stream>>>(images, scalars, static_cast<OutT*>(out),
                                           h, w, planar, epi, rows_cap);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool NEAREST, bool EPILOGUE>
int launch_out(const uint8_t* images, const float* scalars, void* out,
               bool out_bf16, int b, int h, int w, bool planar,
               const Epilogue& epi, cudaStream_t stream) {
  if (out_bf16)
    return launch_typed<C, NEAREST, EPILOGUE, __nv_bfloat16>(images, scalars, out, b, h,
                                                             w, planar, epi, stream);
  return launch_typed<C, NEAREST, EPILOGUE, float>(images, scalars, out, b, h, w,
                                                   planar, epi, stream);
}

template <int C>
int launch_channels(const uint8_t* images, const float* scalars, void* out,
                    bool out_bf16, int b, int h, int w, bool nearest,
                    bool epilogue, bool planar, const Epilogue& epi,
                    cudaStream_t stream) {
  if (nearest) {
    if (epilogue)
      return launch_out<C, true, true>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
    return launch_out<C, true, false>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
  }
  if (epilogue)
    return launch_out<C, false, true>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
  return launch_out<C, false, false>(images, scalars, out, out_bf16, b, h, w, planar, epi, stream);
}

}  // namespace

// images: uint8 [B,H,W,C] contiguous; scalars: float32 [B,8] contiguous;
// out: [B,H,W,C], or [B,C*H,W] when planar != 0, float32 (out_bf16 == 0) or
// bfloat16.  mean/std hold C values each and are read only when
// epilogue != 0.  Returns the CUDA error code of the device query, of the
// shared-memory opt-in (made once per kernel instance and device) or of the
// launch (0 on success).
extern "C" int medseg_warp_affine_u8(const void* images, const void* scalars,
                                     void* out, int b, int h, int w, int c,
                                     int nearest, int out_bf16, int epilogue,
                                     int planar, const float* mean,
                                     const float* std, void* stream) {
  if (b < 1 || b > 65535 || h < 2 || w < 2 || c < 1 || c > kMaxChannels)
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
    case 1: return launch_channels<1>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st);
    case 2: return launch_channels<2>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st);
    case 3: return launch_channels<3>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st);
    default: return launch_channels<4>(img, sc, out, out_bf16, b, h, w, nearest, epilogue, planar, epi, st);
  }
}
