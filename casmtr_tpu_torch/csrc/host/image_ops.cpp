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

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

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

}  // extern "C"
