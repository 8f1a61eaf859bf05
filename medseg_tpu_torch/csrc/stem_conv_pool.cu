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
// summed in float32, the bias is added, then ReLU and the pool run, and the
// pooled value is rounded once (bfloat16: to nearest even).  The conv pads
// with zeros.  The pool's padding is taken as 0, which is exact because
// every value after ReLU is >= 0 and each window holds at least one real
// value.  The plain PyTorch version is
// medseg_tpu_torch/ops/kernels/stem_kernel.py::stem_conv_pool_reference
// (float32 conv, bias, ReLU, pool); the two differ only in the order of
// the float32 sum.
//
// Design.  The TPU kernel's space-to-4-depth phase planes, paired outputs
// and K=192 padding exist because Mosaic rejects strided slices and
// non-aligned contractions.  Here the unit of work is a tile of 8x8 pooled
// outputs for all 64 channels of one image; its 17x17 conv outputs overlap
// the neighbouring tiles' by one row and column (13% of the conv twice).
//
// bfloat16 (the path the port runs): the conv is an implicit GEMM on the
// tensor cores, mma.sync m16n8k16 bf16 -> float32, with M = the tile's 289
// conv positions (19 blocks of 16, padded to 20), N = 64 channels, K = the
// 147 taps laid out as 88 pairs: for each of the 21 (input channel, kernel
// row) rows, kernel columns (-1, 0), (1, 2), (3, 4), (5, 6), where column -1
// and pairs 84..87 carry zero weights.  Each pair is two adjacent bfloat16
// values of the staged patch at an even offset, so an A fragment register
// is one 32-bit shared load at a constant offset from the position, and the
// im2col matrix never exists.  The kernel is persistent: as many CTAs of 8
// warps as fit (two per SM) each walk tiles.
//   1. once per CTA: the weights as [64][88] bf16 pairs (rows padded to 92
//      words against bank conflicts) and the bias go to shared memory, and
//      each warp takes the B fragments of its 32 channels (warp % 2) for
//      the first 10 k-steps into 80 registers, held for the whole kernel;
//   2. per tile: the 39x48 bf16 input patch of each channel (zeros outside
//      the image) was loaded by cp.async into one of two buffers while the
//      previous tile was computed (element by element when the row pitch
//      is not a multiple of 16 bytes);
//   3. each warp walks 5 blocks of 16 positions (warp / 2 + 4i); per block
//      and k-step it gathers one A fragment (4 shared loads) and runs 4 mma,
//      one per 8-channel block, into float32 accumulators; the last k-step,
//      whose upper half is zero weights, reads its B register from shared
//      memory;
//   4. bias and ReLU, rounded once to bf16 (two values per conversion), go
//      into a [289][72] conv tile in shared memory (round-to-nearest-even is
//      monotone, so the max of rounded values is the rounded max);
//   5. each thread takes the 3x3 stride-2 max of 8 channels of one pooled
//      output (per-halfword unsigned max: the values are >= +0) and writes
//      them as one 16-byte NHWC store.
// float32: the same tiles, one CTA per tile and 32 channels, with the conv
// as float32 SIMT fmaf.  The tensor cores take float32 only as TF32 (10-bit
// mantissa), which over 147 taps would miss the 1e-4 float32 tolerance, and
// no path of the port runs the stem in float32.
//
// Bound.  Operations: 147 multiply-adds for each of the B*(H/2)*(W/2)*64
// conv outputs; at B=128, 256x256 that is 39.5 GFLOP, 40 us on the bf16
// tensor cores (989 TFLOP/s).  Bytes: 50.3 MB planar bf16 in + 67.1 MB out =
// 117.4 MB, 35 us at 3.35 TB/s.  The padding of K (176 for 147) and M (320
// for 289) and the tile overlap bring the tensor-core work to 1.6x that.
// What limits this design is shared memory: one 128-byte wavefront of A
// gathers per mma (the two warps of a position group gather the same A),
// plus the conv tile's writes and the pool's reads; mma.sync also runs below
// the rate that wgmma reaches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kOutChannels = 64;
constexpr int kTile = 8;                      // pooled outputs per tile side
constexpr int kConv = 2 * kTile + 1;          // conv outputs per tile side
constexpr int kPatch = 2 * (kConv - 1) + 7;   // input rows/cols per tile: 39
constexpr int kTaps = 3 * 7 * 7;
constexpr int kPositions = kConv * kConv;     // 289 conv outputs per tile

// ---- bfloat16: tensor cores -------------------------------------------
constexpr int kMmaWarps = 8;                  // 2 channel halves x 4 position groups
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kWarpBlocks = 5;                // 16-position blocks per warp
constexpr int kMBlocks = kWarpBlocks * kMmaWarps / 2;  // 20 >= ceil(289 / 16)
constexpr int kPatchCols = 48;                // staged input columns (6 x 16 B)
constexpr int kColShift = 3;                  // patch column of input col 4*px0-5
constexpr int kPlane = kPatch * kPatchCols;   // bf16 elements per channel
constexpr int kKRows = 3 * 7;                 // (input channel, kernel row) rows
constexpr int kPairs = 88;                    // 84 tap pairs + 4 zero pairs
constexpr int kKSteps = 2 * kPairs / 16;      // 11
constexpr int kWStride = 92;                  // words per channel's weight row
constexpr int kConvStride = 72;               // bf16 per conv position
constexpr int kPatchBytes = 3 * kPlane * 2;
constexpr int kWeightBytes = kOutChannels * kWStride * 4;
constexpr int kConvBytes = kPositions * kConvStride * 2;
// dynamic shared memory: weights, conv tile, two patches, bias
constexpr int kMmaSmem = kWeightBytes + kConvBytes + 2 * kPatchBytes + kOutChannels * 4;
static_assert(kWeightBytes % 16 == 0 && kConvBytes % 16 == 0, "16-byte regions");
static_assert(kKSteps * 16 == 2 * kPairs, "K is a whole number of k-steps");
static_assert(kMBlocks * 16 >= kPositions, "every conv position has a row");
static_assert(kPatchBytes % 16 == 0 && kPlane % 2 == 0, "aligned pairs");
static_assert(2 * (kConv - 1) + 6 + kColShift < kPatchCols, "patch width");
static_assert(2 * (kConv - 1) + 6 < kPatch, "patch height");

#ifndef MEDSEG_CUDA_EMULATION  // tests/cuda_emulation.h gives a CPU version
// d += a * b for one m16n8k16 tile: bf16 A (row-major) and B (column-major)
// fragments, float32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros instead when !valid.  Completes at cp_async_wait_all.
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
// Two floats rounded to bf16 (nearest even) in one conversion, lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  uint32_t bits;
  memcpy(&bits, &pair, sizeof(bits));
  return bits;
}

// The input patch of pooled tile (py0, px0) of image b: patch row r,
// column s hold input row 4*py0 - 5 + r, column 4*px0 - 8 + s of each
// channel, zeros outside the image.  With 16-byte rows (wide) the copies
// are asynchronous and land at cp_async_wait_all.
__device__ __forceinline__ void stage_patch(const uint16_t* __restrict__ planes,
                                            uint16_t* patch, int b, int py0,
                                            int px0, int h, int w, bool wide) {
  const uint16_t* img = planes + static_cast<size_t>(b) * 3 * h * w;
  const int iy0 = 4 * py0 - 5;
  const int ix0 = 4 * px0 - 5 - kColShift;
  if (wide) {
    constexpr int kUnits = kPatchCols / 8;
    for (int i = threadIdx.x; i < 3 * kPatch * kUnits; i += kMmaThreads) {
      const int row = i / kUnits;  // channel * kPatch + patch row
      const int u = i - row * kUnits;
      const int ci = row / kPatch;
      const int iy = iy0 + row - ci * kPatch;
      const int ix = ix0 + 8 * u;  // a multiple of 8: wholly inside or outside
      const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
      cp_async_16(patch + row * kPatchCols + 8 * u,
                  inside ? img + (static_cast<size_t>(ci) * h + iy) * w + ix : img, inside);
    }
  } else {
    for (int i = threadIdx.x; i < 3 * kPatch * kPatchCols; i += kMmaThreads) {
      const int row = i / kPatchCols;
      const int s = i - row * kPatchCols;
      const int ci = row / kPatch;
      const int iy = iy0 + row - ci * kPatch;
      const int ix = ix0 + s;
      patch[i] = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                     ? img[(static_cast<size_t>(ci) * h + iy) * w + ix]
                     : static_cast<uint16_t>(0);
    }
  }
}

// Persistent: each CTA stages the weights once, then walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... (tile = (b * tiles_y + ty) *
// tiles_x + tx).
__global__ void __launch_bounds__(kMmaThreads, 2)
stem_conv_pool_bf16_kernel(const uint16_t* __restrict__ planes,
                           const uint16_t* __restrict__ weight,
                           const uint16_t* __restrict__ bias,
                           uint16_t* __restrict__ out, int h, int w, int tiles_x,
                           int tiles_y, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wts = reinterpret_cast<uint32_t*>(smem);                    // [64][kWStride]
  uint16_t* conv = reinterpret_cast<uint16_t*>(smem + kWeightBytes);    // [289][kConvStride]
  uint16_t* patches =
      reinterpret_cast<uint16_t*>(smem + kWeightBytes + kConvBytes);    // [2][3][kPatch][kPatchCols]
  float* bias_s = reinterpret_cast<float*>(smem + kWeightBytes + kConvBytes + 2 * kPatchBytes);

  const int ph = h / 4;
  const int pw = w / 4;
  const int tid = threadIdx.x;
  const bool wide = w % 8 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  auto tile_origin = [&](int tile, int& b, int& py0, int& px0) {
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    py0 = (rest % tiles_y) * kTile;
    px0 = tx * kTile;
    b = rest / tiles_y;
  };

  // 1. Once per CTA: the bias, the weights as bf16 pairs (pair p: channel
  //    p/28, kernel row p/4 % 7, columns 2*(p%4) - 1 and 2*(p%4)), the first
  //    tile's patch, and this warp's B fragments.
  for (int c = tid; c < kOutChannels; c += kMmaThreads)
    bias_s[c] = bf16_bits_to_float(bias[c]);
  for (int i = tid; i < kOutChannels * kPairs; i += kMmaThreads) {
    const int n = i / kPairs;
    const int p = i - n * kPairs;
    uint32_t pair = 0;
    if (p < 84) {
      const uint16_t* row = weight + n * kTaps + (p / 4) * 7;  // (channel, kernel row)
      const int q = p % 4;
      pair = (q > 0 ? static_cast<uint32_t>(row[2 * q - 1]) : 0u) |
             (static_cast<uint32_t>(row[2 * q]) << 16);
    }
    wts[n * kWStride + p] = pair;
  }
  int b, py0, px0;
  if (blockIdx.x < static_cast<unsigned>(n_tiles)) {
    tile_origin(blockIdx.x, b, py0, px0);
    stage_patch(planes, patches, b, py0, px0, h, w, wide);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int half = warp % 2;   // channels 32*half .. 32*half + 31
  const int group = warp / 2;  // position blocks group, group + 4, ...
  // This warp's B fragments for all but the last k-step, held in registers
  // for the whole kernel; the last, half of whose k are zero weights, reads
  // its one real register per block from shared memory.
  constexpr int kHeld = kKSteps - 1;
  static_assert(2 * kHeld + 1 == kKRows, "the last k-step holds one (channel, row)");
  uint32_t bfrag[kHeld][4][2];
#pragma unroll
  for (int ks = 0; ks < kHeld; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* wrow = wts + (8 * (4 * half + j) + g) * kWStride + 8 * ks + q;
      bfrag[ks][j][0] = wrow[0];
      bfrag[ks][j][1] = wrow[4];
    }
  }
  const uint32_t* wlast = wts + (32 * half + g) * kWStride + 8 * kHeld + q;

  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    // only the border flags stay live through the conv (registers are tight)
    const bool top = tile / tiles_x % tiles_y == 0;
    const bool left = tile % tiles_x == 0;
    const uint16_t* patch = patches + buf * (kPatchBytes / 2);
    // 2. The next tile's patch, into the other buffer, which the previous
    //    tile's conv finished reading before the last barrier.
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      int nb_, ny, nx;
      tile_origin(next, nb_, ny, nx);
      stage_patch(planes, patches + (buf ^ 1) * (kPatchBytes / 2), nb_, ny, nx, h, w, wide);
    }

    // 3. The conv, one block of 16 positions at a time (rows past the
    //    289th repeat the last position), and 4. its bias, ReLU and bf16
    //    rounding into the conv tile; conv row/column -1 of the image is
    //    pool padding.
#pragma unroll 1
    for (int i = 0; i < kWarpBlocks; ++i) {
      const int blk = group + 4 * i;
      int base[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int p = min(blk * 16 + g + 8 * hi, kPositions - 1);
        const int ly = p / kConv;
        base[hi] = 2 * ly * kPatchCols + 2 * (p - ly * kConv) + 2 * q - 1 + kColShift;
      }
      // The A fragment of one (channel, kernel row) row r of the 21: its
      // patch offset is a constant.
      auto a_row = [&](int r, uint32_t& at_g, uint32_t& at_g8) {
        const int off = (r / 7) * kPlane + (r % 7) * kPatchCols;
        at_g = *reinterpret_cast<const uint32_t*>(patch + base[0] + off);
        at_g8 = *reinterpret_cast<const uint32_t*>(patch + base[1] + off);
      };
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kHeld; ++ks) {  // pairs 8ks + q and 8ks + 4 + q: rows 2ks, 2ks+1
        uint32_t a[4];
        a_row(2 * ks, a[0], a[1]);
        a_row(2 * ks + 1, a[2], a[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[j], a, bfrag[ks][j]);
      }
      {  // row 20, then four zero pairs: their products are taken as zeros
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        a_row(2 * kHeld, a[0], a[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bw[2] = {wlast[8 * j * kWStride], 0u};
          mma_bf16_16816(acc[j], a, bw);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int p = blk * 16 + g + 8 * hi;
        if (p >= kPositions) continue;
        const int ly = p / kConv;
        const int lx = p - ly * kConv;
        const bool pad = (top && ly == 0) || (left && lx == 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * (4 * half + j) + 2 * q;
          const float v0 = acc[j][2 * hi] + bias_s[c];
          const float v1 = acc[j][2 * hi + 1] + bias_s[c + 1];
          const uint32_t pair =
              pad ? 0u : pack_bf16x2(v0 > 0.0f ? v0 : 0.0f, v1 > 0.0f ? v1 : 0.0f);
          *reinterpret_cast<uint32_t*>(conv + p * kConvStride + c) = pair;
        }
      }
    }
    __syncthreads();  // the conv tile is whole
    tile_origin(tile, b, py0, px0);

    // 5. Max pool 3x3 stride 2: pooled (qy, qx) reads conv rows 2qy..2qy+2;
    //    one item is 8 channels of one pooled output.
    for (int i = tid; i < kTile * kTile * 8; i += kMmaThreads) {
      const int pq = i / 8;
      const int chunk = i - 8 * pq;
      const int qy = pq / kTile;
      const int qx = pq - qy * kTile;
      if (py0 + qy >= ph || px0 + qx >= pw) continue;
      uint4 m = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              conv + ((2 * qy + dy) * kConv + 2 * qx + dx) * kConvStride + 8 * chunk);
          m.x = __vmaxu2(m.x, v.x);
          m.y = __vmaxu2(m.y, v.y);
          m.z = __vmaxu2(m.z, v.z);
          m.w = __vmaxu2(m.w, v.w);
        }
      }
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * ph + py0 + qy) * pw + px0 + qx) * kOutChannels +
          8 * chunk) = m;
    }
    cp_async_wait_all();
    __syncthreads();  // the next patch has landed, and the pool is done with the conv tile
  }
}

// ---- float32: SIMT ----------------------------------------------------
constexpr int kF32PatchStride = 40;           // padded row of the patch
constexpr int kChannels = 32;                 // output channels per CTA
constexpr int kThreads = 256;
constexpr int kGroupChannels = 8;             // channels per thread in the conv
constexpr int kGroups = kChannels / kGroupChannels;     // 4
constexpr int kPosStride = kThreads / kGroups;          // 64
constexpr int kPosPerThread = (kPositions + kPosStride - 1) / kPosStride;  // 5
constexpr int kPatchFloats = 3 * kPatch * kF32PatchStride;  // 4680
constexpr int kWeightFloats = kTaps * kChannels;            // 4704
constexpr int kConvFloats = kPositions * kChannels;         // 9248
constexpr int kSmemFloats = kPatchFloats + kWeightFloats;
static_assert(kConvFloats <= kSmemFloats, "conv tile reuses the staging space");
static_assert(kPatchFloats % 4 == 0, "weights need 16-byte alignment");

// One CTA per (image, 8x8 pooled tile, 32 channels): the 39x39x3 patch and
// 147x32 weights staged as float32, 5 positions x 8 channels per thread in
// explicit fmaf (the library's -fmad=false only stops the compiler from
// contracting a separate multiply and add), then the conv tile and pool.
__global__ void __launch_bounds__(kThreads)
stem_conv_pool_f32_kernel(const float* __restrict__ planes,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias, float* __restrict__ out,
                          int h, int w) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* patch = smem;                 // [3][kPatch][kF32PatchStride]
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
  const float* img = planes + static_cast<size_t>(b) * 3 * h * w;
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
      v = img[(static_cast<size_t>(ci) * h + iy) * w + ix];
    patch[(ci * kPatch + r) * kF32PatchStride + s] = v;
  }
  // ... and the weights, transposed to [tap][channel].
  for (int i = tid; i < kTaps * kChannels; i += kThreads) {
    const int c = i / kTaps;
    const int tap = i - c * kTaps;
    wts[tap * kChannels + c] = weight[(c0 + c) * kTaps + tap];
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
    base[k] = 2 * ly * kF32PatchStride + 2 * lx;
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
        const float* src = patch + (ci * kPatch + ky) * kF32PatchStride + kx;
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
    bv[j] = bias[c0 + group * kGroupChannels + j];
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
    out[((static_cast<size_t>(b) * ph + py0 + qy) * pw + px0 + qx) * kOutChannels + c0 + c] = m;
  }
}

}  // namespace

// planes: [B, 3*H, W] contiguous; weight: [64, 3, 7, 7] contiguous (BN
// folded); bias: [64]; out: [B, H/4, W/4, 64].  All float32 (bf16 == 0) or
// all bfloat16.  H and W are multiples of 4.  Returns the CUDA error code of
// the bf16 kernel's device query, shared-memory opt-in and occupancy queries
// (the last two once per device) or of the launch (0 on success).
extern "C" int medseg_stem_conv_pool(const void* planes, const void* weight,
                                     const void* bias, void* out, int b, int h,
                                     int w, int bf16, void* stream) {
  if (b < 1 || b > 65535 || h < 4 || w < 4 || h % 4 != 0 || w % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles_y = (h / 4 + kTile - 1) / kTile;
  const int tiles_x = (w / 4 + kTile - 1) / kTile;
  if (bf16) {
    // as many CTAs as fit on the card at once, each walking its tiles; the
    // shared-memory opt-in and that count are worked out once per device
    auto* kernel = stem_conv_pool_bf16_kernel;
    static std::atomic<int> resident_ctas[kMaxDevices];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && (device < 0 || device >= kMaxDevices))
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    int resident = resident_ctas[device].load(std::memory_order_acquire);
    if (resident == 0) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMmaSmem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads,
                                                            kMmaSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = (per_sm > 0 ? per_sm : 1) * sms;
      resident_ctas[device].store(resident, std::memory_order_release);
    }
    const long long n_tiles = static_cast<long long>(tiles_x) * tiles_y * b;
    if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(n_tiles < resident ? n_tiles : resident);
    kernel<<<grid, kMmaThreads, kMmaSmem, st>>>(
        static_cast<const uint16_t*>(planes), static_cast<const uint16_t*>(weight),
        static_cast<const uint16_t*>(bias), static_cast<uint16_t*>(out), h, w, tiles_x,
        tiles_y, static_cast<int>(n_tiles));
  } else {
    const dim3 grid(tiles_x * (kOutChannels / kChannels), tiles_y, b);
    stem_conv_pool_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(planes), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
