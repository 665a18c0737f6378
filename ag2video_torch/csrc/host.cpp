// The port's host-side data plane: clip resize + ImageNet normalisation, box
// padding, and the PNG row unfilter, called from Python through ctypes
// (ag2video_torch/data/native.py), which releases the interpreter lock for
// the whole call.
//
// agtpu_clip_resize_normalize, agtpu_pad_boxes and agtpu_version are the
// port's own copy of the JAX package's native/agtpu_host.cpp, with the same
// arithmetic: built with the same flags on one machine, the two libraries
// give the same bits (tests/test_torch_host.py). agtpu_png_unfilter undoes
// PNG's per-row filters for data/png.py, so reading a frame needs no PIL.
//
// Built by g++ at first use (ops/_kernels.py: HOST_CXXFLAGS, the flags of
// native/Makefile) into ag2video_torch/_build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Bilinear sample with half-pixel centers (align_corners=false convention,
// matching PIL/cv2 resize geometry).
inline void resize_bilinear_frame(const uint8_t* src, int in_h, int in_w,
                                  float* dst, int out_h, int out_w,
                                  const float* mean, const float* inv_std) {
  const float sy = static_cast<float>(in_h) / out_h;
  const float sx = static_cast<float>(in_w) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float ty = fy - y0;
    int y0c = std::clamp(y0, 0, in_h - 1);
    int y1c = std::clamp(y0 + 1, 0, in_h - 1);
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float tx = fx - x0;
      int x0c = std::clamp(x0, 0, in_w - 1);
      int x1c = std::clamp(x0 + 1, 0, in_w - 1);
      const uint8_t* p00 = src + (y0c * in_w + x0c) * 3;
      const uint8_t* p01 = src + (y0c * in_w + x1c) * 3;
      const uint8_t* p10 = src + (y1c * in_w + x0c) * 3;
      const uint8_t* p11 = src + (y1c * in_w + x1c) * 3;
      float* out = dst + (oy * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - tx) + p01[c] * tx;
        float bot = p10[c] * (1 - tx) + p11[c] * tx;
        float v = (top * (1 - ty) + bot * ty) * (1.0f / 255.0f);
        out[c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

void parallel_frames(int n_frames, int n_threads,
                     const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n_frames <= 1) {
    for (int t = 0; t < n_frames; ++t) fn(t);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  int workers = std::min(n_threads, n_frames);
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      int t;
      while ((t = next.fetch_add(1)) < n_frames) fn(t);
    });
  }
  for (auto& th : pool) th.join();
}

// PNG's Paeth predictor (PNG specification, section 9.4).
inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Resize a clip of T HxWx3 uint8 frames to out_h x out_w and apply
// (x/255 - mean) / std per channel. dst shape: (T, out_h, out_w, 3) f32.
void agtpu_clip_resize_normalize(const uint8_t* src, int n_frames, int in_h,
                                 int in_w, float* dst, int out_h, int out_w,
                                 const float* mean, const float* std,
                                 int n_threads) {
  float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;
  parallel_frames(n_frames, n_threads, [&](int t) {
    resize_bilinear_frame(src + t * in_stride, in_h, in_w,
                          dst + t * out_stride, out_h, out_w, mean, inv_std);
  });
}

// Fixed-cap padded collation of per-sample boxes:
// src (T, O_in, 4) f32 -> dst (T, O_cap, 4) filled with pad_value.
void agtpu_pad_boxes(const float* src, int n_frames, int o_in, float* dst,
                     int o_cap, float pad_value) {
  for (int t = 0; t < n_frames; ++t) {
    float* row = dst + static_cast<size_t>(t) * o_cap * 4;
    for (int i = 0; i < o_cap * 4; ++i) row[i] = pad_value;
    std::memcpy(row, src + static_cast<size_t>(t) * o_in * 4,
                sizeof(float) * std::min(o_in, o_cap) * 4);
  }
}

// Undo PNG's per-row filters (PNG specification, section 9): src holds
// `height` rows of 1 + row_bytes bytes, a filter type (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth) and then the filtered bytes; dst receives the
// height x row_bytes raw bytes. bpp: bytes per pixel, the distance to the
// left neighbour. Average and Paeth depend on the byte just decoded, so a
// row is one sequential pass. Returns 0, or 1 + the index of the first row
// whose filter type is unknown.
int agtpu_png_unfilter(const uint8_t* src, int height, int row_bytes,
                       int bpp, uint8_t* dst) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * (row_bytes + 1);
    const uint8_t kind = *in++;
    uint8_t* out = dst + static_cast<size_t>(y) * row_bytes;
    const uint8_t* up = y > 0 ? out - row_bytes : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(out, in, row_bytes);
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          out[i] = in[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

int agtpu_version() { return 1; }

}  // extern "C"
