// Native data loader: multithreaded PNG decode + resize for the packed cache.
//
// A copy of medseg_tpu/native/loader.cpp inside the PyTorch port (the port
// imports nothing of the JAX package); only the comments differ.  The
// reference decodes every PNG in CPU dataloader workers every epoch
// (reference utils/trainer.py:153-160); the port decodes each split ONCE
// into packed uint8 arrays (`pack`), and this library makes that one-time
// pass fast: a thread pool decodes PNGs with libpng's simplified API and
// resizes directly into the caller-provided numpy buffer.
//
// Resize semantics match cv2's (and the packed cache's cv2 route):
//   bilinear: src = (dst + 0.5) * scale - 0.5, edge-clamped (half-pixel)
//   nearest:  src = floor(dst * scale)
//   letterbox: aspect-preserving bilinear to longest-side + centered zero pad
//
// Built at first use by medseg_tpu_torch/native/loader.py
// (g++ -O3 -march=native -shared -fPIC -std=c++17 ... -lpng -lz -lpthread).

#include <png.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;
  int h = 0, w = 0, ch = 0;
};

bool decode_png(const char* path, int want_channels, Image* out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = (want_channels == 1) ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  out->h = image.height;
  out->w = image.width;
  out->ch = want_channels;
  out->data.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->data.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// Bilinear resize, half-pixel convention, float accumulation (matches cv2's
// float path).
void resize_bilinear(const Image& src, uint8_t* dst, int dh, int dw) {
  const int ch = src.ch;
  const float sy = static_cast<float>(src.h) / dh;
  const float sx = static_cast<float>(src.w) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(std::floor(fx));
    float wx = fx - x0;
    x0s[x] = std::min(std::max(x0, 0), src.w - 1);
    x1s[x] = std::min(std::max(x0 + 1, 0), src.w - 1);
    wxs[x] = wx;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), src.h - 1);
    int y1c = std::min(std::max(y0 + 1, 0), src.h - 1);
    const uint8_t* r0 = src.data.data() + static_cast<size_t>(y0c) * src.w * ch;
    const uint8_t* r1 = src.data.data() + static_cast<size_t>(y1c) * src.w * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p00 = r0 + static_cast<size_t>(x0s[x]) * ch;
      const uint8_t* p01 = r0 + static_cast<size_t>(x1s[x]) * ch;
      const uint8_t* p10 = r1 + static_cast<size_t>(x0s[x]) * ch;
      const uint8_t* p11 = r1 + static_cast<size_t>(x1s[x]) * ch;
      float wx = wxs[x];
      for (int c = 0; c < ch; ++c) {
        float top = p00[c] * (1.f - wx) + p01[c] * wx;
        float bot = p10[c] * (1.f - wx) + p11[c] * wx;
        float v = top * (1.f - wy) + bot * wy;
        drow[static_cast<size_t>(x) * ch + c] =
            static_cast<uint8_t>(std::lround(std::min(std::max(v, 0.f), 255.f)));
      }
    }
  }
}

void resize_nearest(const Image& src, uint8_t* dst, int dh, int dw) {
  const int ch = src.ch;
  const float sy = static_cast<float>(src.h) / dh;
  const float sx = static_cast<float>(src.w) / dw;
  for (int y = 0; y < dh; ++y) {
    int ys = std::min(static_cast<int>(std::floor(y * sy)), src.h - 1);
    const uint8_t* srow = src.data.data() + static_cast<size_t>(ys) * src.w * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      int xs = std::min(static_cast<int>(std::floor(x * sx)), src.w - 1);
      std::memcpy(drow + static_cast<size_t>(x) * ch,
                  srow + static_cast<size_t>(xs) * ch, ch);
    }
  }
}

// LongestMaxSize + centered zero pad (reference utils/trainer.py:52-60).
void letterbox(const Image& src, uint8_t* dst, int size) {
  const int ch = src.ch;
  float scale = static_cast<float>(size) / std::max(src.h, src.w);
  int nh = std::max(1, static_cast<int>(std::lround(src.h * scale)));
  int nw = std::max(1, static_cast<int>(std::lround(src.w * scale)));
  std::vector<uint8_t> tmp(static_cast<size_t>(nh) * nw * ch);
  resize_bilinear(src, tmp.data(), nh, nw);
  std::memset(dst, 0, static_cast<size_t>(size) * size * ch);
  int top = (size - nh) / 2;
  int left = (size - nw) / 2;
  for (int y = 0; y < nh; ++y) {
    std::memcpy(dst + ((static_cast<size_t>(top) + y) * size + left) * ch,
                tmp.data() + static_cast<size_t>(y) * nw * ch,
                static_cast<size_t>(nw) * ch);
  }
}

}  // namespace

extern "C" int decode_resize_batch(const char** paths, int n, void* out_buf,
                                   int out_size, int channels, int do_letterbox,
                                   int do_nearest, int nthreads) {
  uint8_t* out = static_cast<uint8_t*>(out_buf);
  const size_t stride =
      static_cast<size_t>(out_size) * out_size * channels;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok; else 1-based index of first failure

  auto worker = [&]() {
    Image img;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) break;
      if (!decode_png(paths[i], channels, &img)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        break;
      }
      uint8_t* dst = out + stride * i;
      if (do_letterbox) {
        letterbox(img, dst, out_size);
      } else if (do_nearest) {
        resize_nearest(img, dst, out_size, out_size);
      } else if (img.h == out_size && img.w == out_size) {
        std::memcpy(dst, img.data.data(), stride);
      } else {
        resize_bilinear(img, dst, out_size, out_size);
      }
    }
  };

  int k = std::max(1, nthreads);
  std::vector<std::thread> threads;
  threads.reserve(k);
  for (int t = 0; t < k; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}
