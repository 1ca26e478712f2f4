// Host image resampling of the input pipeline.  Plain C interface (ctypes).
//
// casmtr_resize_pad_normalize: the fused bilinear resize + bottom-right pad
// + [0, 1] scaling of the JAX package's native image op
// (casmtr_tpu/native/image_ops.cpp), with its half-pixel centres, index
// clamp, gray broadcast and float arithmetic, into a zeroed float32 canvas.
// That op is built with -march=native, under which GCC fuses its a + b * c
// into fused multiply-adds on any x86-64 with FMA; the same fusions are
// spelled out here with std::fma (exact on every machine, so the result
// does not depend on the build's -march).
//
// casmtr_resize_linear_u8: OpenCV's cv::resize(INTER_LINEAR) of 8-bit
// images: 11-bit fixed-point coefficients (INTER_RESIZE_COEF_BITS) from
// float offsets, an exact horizontal pass, and the rounding of its
// vectorised vertical pass, (((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2)
// >> 2, on every output (bit-equal to cv2 5.0 at every size tried, odd row
// widths included); an exact 2x reduction goes to its INTER_AREA path, and
// an unchanged size is a copy.
//
// casmtr_resize_linear_f32: cv2.resize(INTER_LINEAR) of float32 images as
// OpenCV 5.0's x86 build computes it (bit-equal at every size tried with
// two or more rows and columns, an exact 2x reduction included): each
// output's source coordinate (d + 0.5) * (1 / (dst / src)) - 0.5 in
// double, its floor s clamped to [0, n - 1] and s + 1 likewise, the
// fraction rounded to float32 once, and a + f * (b - a) with b - a rounded
// to float32 and one fused multiply-add; a horizontal pass, then a
// vertical one.  An unchanged size is a copy.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The float32 resize's source indices and fractions along one axis.
void linear_coefs(int n_dst, int n_src, std::vector<int>& i0,
                  std::vector<int>& i1, std::vector<float>& f) {
  const double scale = 1. / ((double)n_dst / n_src);
  i0.resize(n_dst), i1.resize(n_dst), f.resize(n_dst);
  for (int d = 0; d < n_dst; d++) {
    const double x = (d + 0.5) * scale - 0.5;
    const double s = std::floor(x);
    f[d] = (float)(x - s);
    i0[d] = clampi((int)s, 0, n_src - 1);
    i1[d] = clampi((int)s + 1, 0, n_src - 1);
  }
}

// The float32 resize's two passes, built twice on x86-64: with the FMA
// instructions, picked at load time where the CPU has them, and without,
// where std::fma is a library call.  Both round each multiply-add once.
#if defined(__x86_64__) && defined(__GNUC__) && !defined(__clang__)
#define CASMTR_FMA_CLONES __attribute__((target_clones("fma", "default")))
#else
#define CASMTR_FMA_CLONES
#endif

// one source row [sw, cn] -> d [dw, cn]
CASMTR_FMA_CLONES
void lerp_columns(const float* s, const int* x0, const int* x1,
                  const float* fx, int dw, int cn, float* d) {
  if (cn == 3) {  // RGB, the Matcher's images: the channel loop unrolled
    for (int dx = 0; dx < dw; dx++) {
      const float* a = s + (size_t)x0[dx] * 3;
      const float* b = s + (size_t)x1[dx] * 3;
      const float f = fx[dx];
      d[dx * 3] = std::fma(f, b[0] - a[0], a[0]);
      d[dx * 3 + 1] = std::fma(f, b[1] - a[1], a[1]);
      d[dx * 3 + 2] = std::fma(f, b[2] - a[2], a[2]);
    }
    return;
  }
  for (int dx = 0; dx < dw; dx++) {
    const float* a = s + (size_t)x0[dx] * cn;
    const float* b = s + (size_t)x1[dx] * cn;
    for (int c = 0; c < cn; c++)
      d[dx * cn + c] = std::fma(fx[dx], b[c] - a[c], a[c]);
  }
}

// two resized rows -> d [n]
CASMTR_FMA_CLONES
void lerp_rows(const float* s0, const float* s1, float f, float* d, int n) {
  for (int x = 0; x < n; x++) d[x] = std::fma(f, s1[x] - s0[x], s0[x]);
}

}  // namespace

extern "C" {

// src uint8 [sh, sw, sc]; canvas float32 [pad, pad, 3] and mask uint8
// [pad, pad], both zeroed by the caller.
void casmtr_resize_pad_normalize(const uint8_t* src, int sh, int sw, int sc,
                                 int dh, int dw, int pad, float* canvas,
                                 uint8_t* mask) {
  const float scale = 1.f / 255.f;
  const float sy_ratio = (dh > 1) ? (float)sh / dh : 0.f;
  const float sx_ratio = (dw > 1) ? (float)sw / dw : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = std::fma(y + 0.5f, sy_ratio, -0.5f);
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = clampi(y0, 0, sh - 1);
    int y1c = clampi(y0 + 1, 0, sh - 1);
    float* out_row = canvas + (size_t)y * pad * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = std::fma(x + 0.5f, sx_ratio, -0.5f);
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = clampi(x0, 0, sw - 1);
      int x1c = clampi(x0 + 1, 0, sw - 1);
      const uint8_t* p00 = src + ((size_t)y0c * sw + x0c) * sc;
      const uint8_t* p01 = src + ((size_t)y0c * sw + x1c) * sc;
      const uint8_t* p10 = src + ((size_t)y1c * sw + x0c) * sc;
      const uint8_t* p11 = src + ((size_t)y1c * sw + x1c) * sc;
      for (int c = 0; c < 3; ++c) {
        int cs = (sc == 1) ? 0 : c;
        float v0 = std::fma(wx, float(p01[cs]) - p00[cs], float(p00[cs]));
        float v1 = std::fma(wx, float(p11[cs]) - p10[cs], float(p10[cs]));
        out_row[(size_t)x * 3 + c] = std::fma(wy, v1 - v0, v0) * scale;
      }
    }
    std::memset(mask + (size_t)y * pad, 1, dw);
  }
}

// src uint8 [sh, sw, cn] -> dst uint8 [dh, dw, cn]
void casmtr_resize_linear_u8(const uint8_t* src, int sh, int sw, int cn,
                             uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, (size_t)sh * sw * cn);
    return;
  }
  const double scale_x = 1. / ((double)dw / sw);
  const double scale_y = 1. / ((double)dh / sh);
  const int iscale_x = (int)std::lrint(scale_x);
  const int iscale_y = (int)std::lrint(scale_y);
  if (iscale_x == 2 && iscale_y == 2 &&
      std::fabs(scale_x - iscale_x) < DBL_EPSILON &&
      std::fabs(scale_y - iscale_y) < DBL_EPSILON) {
    const size_t step = (size_t)sw * cn;
    for (int y = 0; y < dh; y++) {
      const uint8_t* s0 = src + (size_t)2 * y * step;
      const uint8_t* s1 = s0 + step;
      uint8_t* d = dst + (size_t)y * dw * cn;
      for (int x = 0; x < dw; x++)
        for (int c = 0; c < cn; c++) {
          int i = 2 * x * cn + c;
          d[x * cn + c] =
              (uint8_t)((s0[i] + s0[i + cn] + s1[i] + s1[i + cn] + 2) >> 2);
        }
    }
    return;
  }
  const int kScale = 1 << 11;  // INTER_RESIZE_COEF_SCALE
  std::vector<int> xofs(dw);
  std::vector<short> ax(2 * dw);
  std::vector<char> xedge(dw);
  for (int dx = 0; dx < dw; dx++) {
    float fx = (float)((dx + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= sx;
    xedge[dx] = 0;
    if (sx < 0) fx = 0, sx = 0;
    if (sx >= sw - 1) fx = 0, sx = sw - 1, xedge[dx] = 1;
    xofs[dx] = sx;
    ax[2 * dx] = (short)std::lrint((1.f - fx) * kScale);
    ax[2 * dx + 1] = (short)std::lrint(fx * kScale);
  }
  const int width = dw * cn;
  std::vector<int> rows[2] = {std::vector<int>(width), std::vector<int>(width)};
  auto hresize = [&](int sy, int* d) {
    const uint8_t* s = src + (size_t)sy * sw * cn;
    for (int dx = 0; dx < dw; dx++) {
      const int sx = xofs[dx] * cn;
      for (int c = 0; c < cn; c++) {
        d[dx * cn + c] = xedge[dx]
                             ? s[sx + c] * kScale
                             : s[sx + c] * ax[2 * dx] +
                                   s[sx + cn + c] * ax[2 * dx + 1];
      }
    }
  };
  int cached[2] = {-1, -1};
  for (int dy = 0; dy < dh; dy++) {
    float fy = (float)((dy + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= sy;
    const short b0 = (short)std::lrint((1.f - fy) * kScale);
    const short b1 = (short)std::lrint(fy * kScale);
    const int r0 = clampi(sy, 0, sh - 1), r1 = clampi(sy + 1, 0, sh - 1);
    for (int k = 0; k < 2; k++) {
      const int r = k ? r1 : r0;
      if (cached[k] != r) {
        hresize(r, rows[k].data());
        cached[k] = r;
      }
    }
    const int* S0 = rows[0].data();
    const int* S1 = rows[1].data();
    uint8_t* d = dst + (size_t)dy * width;
    for (int x = 0; x < width; x++) {
      int v = ((b0 * (int)(short)(S0[x] >> 4)) >> 16) +
              ((b1 * (int)(short)(S1[x] >> 4)) >> 16);
      d[x] = (uint8_t)clampi((v + 2) >> 2, 0, 255);
    }
  }
}

// src float32 [sh, sw, cn] -> dst float32 [dh, dw, cn]
void casmtr_resize_linear_f32(const float* src, int sh, int sw, int cn,
                              float* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, sizeof(float) * sh * sw * cn);
    return;
  }
  std::vector<int> x0, x1, y0, y1;
  std::vector<float> fx, fy;
  linear_coefs(dw, sw, x0, x1, fx);
  linear_coefs(dh, sh, y0, y1, fy);
  const int width = dw * cn;
  std::vector<float> rows[2] = {std::vector<float>(width),
                                std::vector<float>(width)};
  auto hresize = [&](int sy, float* d) {
    lerp_columns(src + (size_t)sy * sw * cn, x0.data(), x1.data(),
                 fx.data(), dw, cn, d);
  };
  int cached[2] = {-1, -1};
  for (int dy = 0; dy < dh; dy++) {
    const int r0 = y0[dy], r1 = y1[dy];
    if (cached[0] != r0) {
      if (cached[1] == r0) {  // moving down: the lower row becomes the upper
        std::swap(rows[0], rows[1]);
        std::swap(cached[0], cached[1]);
      } else {
        hresize(r0, rows[0].data());
        cached[0] = r0;
      }
    }
    if (cached[1] != r1) {
      hresize(r1, rows[1].data());
      cached[1] = r1;
    }
    lerp_rows(rows[0].data(), rows[1].data(), fy[dy],
              dst + (size_t)dy * width, width);
  }
}

}  // extern "C"
