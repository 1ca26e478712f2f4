// Huffman JPEG decoding as libjpeg-turbo gives it to cv2.imread by
// default: baseline, extended-sequential and progressive Huffman (SOF0,
// SOF1, SOF2) with 8-bit samples and 1 or 3 components, any integral
// sampling factors, restart markers, 8- and 16-bit quantization tables.
// Progressive files (jdphuff.c: DC first and refine scans, interleaved or
// not; AC first and refine scans with end-of-band runs, one component
// each) accumulate the coefficients of the whole image, which are
// dequantized and transformed at the end of the file as a sequential
// file's are at each block (libjpeg's block smoothing acts only on
// coefficients that no scan refined to the last bit, and the decoder
// refuses a file whose scans leave any).  Then the accurate
// integer IDCT of jidctint.c (JDCT_ISLOW), the "fancy" triangle upsampling
// of jdsample.c (h2v1, h2v2, h1v2; plain replication otherwise) and the
// fixed-point YCbCr->RGB and RGB->gray of jdcolor.c.  Grayscale output is
// libjpeg's JCS_GRAYSCALE: the Y plane, no colour conversion.  The EXIF
// orientation is parsed here and applied by the caller.
//
// Arithmetic-coded (SOF9, SOF10, DAC), lossless, hierarchical (SOF5-7,
// SOF13-15) and 12-bit files and CMYK/YCCK (4 components) are refused with
// a message naming the marker.  Plain C interface (ctypes); each call returns 0, or 1 with a
// message in ``err``.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refused {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Refused{msg}; }

// jpeg_natural_order with libjpeg's 16 guard entries for corrupt run lengths
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: code length (0 = longer) and symbol
  uint8_t look_len[512];
  uint8_t look_sym[512];
};

void build_huff(Huff& t, const uint8_t* bits, const uint8_t* vals, int nvals) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("corrupt Huffman table (DHT)");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - (int)huffcode[p];
      p += bits[l - 1];
      t.maxcode[l] = (int)huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.vals, 0, sizeof t.vals);
  std::memcpy(t.vals, vals, nvals);
  std::memset(t.look_len, 0, sizeof t.look_len);
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      int look = (int)huffcode[p] << (9 - l);
      for (int r = 0; r < (1 << (9 - l)); r++) {
        t.look_len[look + r] = (uint8_t)l;
        t.look_sym[look + r] = vals[p];
      }
    }
  }
  t.defined = true;
}

// Entropy-coded bits, MSB first, with 0xFF00 unstuffed.  At a marker the
// reader stops and supplies zero bits, as libjpeg's fill_bit_buffer does.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;
          }
        } else {
          b = *p++;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int n) {
    if (cnt < n) fill();
    return (int)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  void reset() {
    buf = 0;
    cnt = 0;
    at_marker = false;
  }
};

inline int decode_sym(Bits& b, const Huff& t) {
  int look = b.peek(9);
  int l = t.look_len[look];
  if (l) {
    b.skip(l);
    return t.look_sym[look];
  }
  int code = b.get(9);
  l = 9;
  while (l < 17 && code > t.maxcode[l]) {
    code = (code << 1) | b.get(1);
    l++;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg warns and returns 0
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// ---- jidctint.c: jpeg_idct_islow ----
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit, indexed by (x & 1023)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int j = 0; j < 1024; j++) {
      int v;
      if (j < 128) v = j + 128;
      else if (j < 512) v = 255;
      else if (j < 896) v = 0;
      else v = j - 896;
      t[j] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int)((int)in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int)in[16] * q[16], z3 = (int)in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int)in[0] * q[0];
    z3 = (int)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int)in[56] * q[56];
    tmp1 = (int)in[40] * q[40];
    tmp2 = (int)in[24] * q[24];
    tmp3 = (int)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, n);
    w[56] = (int)descale(tmp10 - tmp3, n);
    w[8] = (int)descale(tmp11 + tmp2, n);
    w[48] = (int)descale(tmp11 - tmp2, n);
    w[16] = (int)descale(tmp12 + tmp1, n);
    w[40] = (int)descale(tmp12 - tmp1, n);
    w[24] = (int)descale(tmp13 + tmp0, n);
    w[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int n = kConstBits + kPass1Bits + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = kRange.t[(int)descale(w[0], kPass1Bits + 3) & 1023];
      std::memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, n) & 1023];
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;      // downsampled size (real samples)
  int stride = 0, rows = 0;  // the plane, padded to whole MCUs
  int td = 0, ta = 0, pred = 0;
  bool latched = false, decoded = false;
  int16_t quant[64];
  std::vector<uint8_t> plane;
  // progressive: the coefficients of every block (stride / 8 x rows / 8
  // blocks of 64, natural order), and each coefficient's lowest bit yet
  // to come (-1 before its first scan, 0 when complete)
  std::vector<int16_t> coef;
  int coef_bits[64];
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool frame = false;
  Component comp[4];
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  uint16_t qtab[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool progressive = false;
  int eobrun = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // markers may be preceded by fill bytes; libjpeg skips garbage too
    while (pos < n && data[pos] != 0xFF) pos++;
    while (pos < n && data[pos] == 0xFF) pos++;
    if (pos >= n) fail("no EOI marker: truncated file");
    return data[pos++];
  }

  void read_sof(int m) {
    int len = u16();
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (SOF" +
           std::to_string(m - 0xC0) + ") are not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("a height of 0 (DNL) is not supported");
    if (width == 0) fail("a width of 0");
    if (ncomp == 4) fail("CMYK/YCCK (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + " components are not supported");
    if (len != 8 + 3 * ncomp) fail("corrupt SOF length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt sampling factors or table id (SOF)");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("fractional sampling factors are not supported");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.stride = mcus_x * c.h * 8;
      c.rows = mcus_y * c.v * 8;
    }
    frame = true;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3 || prec > 1) fail("corrupt quantization table (DQT)");
      for (int k = 0; k < 64; k++)
        qtab[tq][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qdef[tq] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
    if (len != 0) fail("corrupt DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc = u8();
      int cls = tc >> 4, th = tc & 15;
      if (cls > 1 || th > 3) fail("corrupt Huffman table (DHT)");
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        bits[i] = (uint8_t)u8();
        total += bits[i];
      }
      if (total > 256) fail("corrupt Huffman table (DHT)");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = (uint8_t)u8();
      build_huff(cls ? ac[th] : dc[th], bits, vals, total);
      len -= 17 + total;
    }
    if (len != 0) fail("corrupt DHT length");
  }

  void read_app(int m) {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) fail("truncated marker segment");
    const uint8_t* s = data + pos;
    if (m == 0xE0 && len >= 5 && !std::memcmp(s, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && len >= 12 && !std::memcmp(s, "Adobe", 5)) {
      adobe = true;
      adobe_transform = s[11];
    }
    if (m == 0xE1 && len >= 14 && !std::memcmp(s, "Exif\0\0", 6) &&
        orientation == 1)
      orientation = exif_orientation(s + 6, len - 6);
    pos += len;
  }

  // IFD0's tag 0x0112 (1-8), else 1
  static int exif_orientation(const uint8_t* t, int len) {
    if (len < 8) return 1;
    bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return 1;
    auto r16 = [&](int o) -> int {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto r32 = [&](int o) -> uint32_t {
      return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) |
                      ((uint32_t)t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24)
                : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) |
                      ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3];
    };
    uint32_t ifd = r32(4);
    if (ifd + 2 > (uint32_t)len) return 1;
    int count = r16((int)ifd);
    for (int i = 0; i < count; i++) {
      uint32_t e = ifd + 2 + 12 * i;
      if (e + 12 > (uint32_t)len) break;
      if (r16((int)e) == 0x0112 && r16((int)e + 2) == 3) {
        int v = r16((int)e + 8);
        return (v >= 1 && v <= 8) ? v : 1;
      }
    }
    return 1;
  }

  void skip_segment() {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) fail("truncated marker segment");
    pos += len;
  }

  static std::string sof_name(int m) {
    char b[8];
    std::snprintf(b, sizeof b, "SOF%d", m - 0xC0);
    return b;
  }

  // Parse markers up to the first SOS (header only) or to EOI (decode).
  void run(bool decode) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("no SOI marker");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) fail("a second SOF marker");
        progressive = m == 0xC2;
        read_sof(m);
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("lossless JPEG (" + sof_name(m) + ") is not supported");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xCD || m == 0xCE) {
        fail("hierarchical JPEG (" + sof_name(m) + ") is not supported");
      } else if (m == 0xC9 || m == 0xCA) {
        fail("arithmetic coding (" + sof_name(m) + ") is not supported");
      } else if (m == 0xCC) {
        fail("arithmetic coding (DAC) is not supported");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) fail("corrupt DRI length");
        restart_interval = u16();
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xDA) {
        if (!frame) fail("SOS before SOF");
        if (!decode) return;
        scan();
      } else if (m == 0xD9) {
        if (!frame) fail("EOI before SOF");
        if (decode && progressive) finish_progressive();
        return;
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker: libjpeg ignores it
      } else if (m == 0xD8) {
        fail("a second SOI marker");
      } else {
        skip_segment();
      }
    }
  }

  void scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("corrupt SOS");
    Component* sc[4];
    int tables[4];
    for (int i = 0; i < ns; i++) {
      int id = u8();
      tables[i] = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("SOS names an unknown component");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahl = u8();
    int ah = ahl >> 4, al = ahl & 15;
    if (progressive) {
      bool dc = ss == 0;
      if ((dc && se != 0) || (!dc && (se < ss || se > 63 || ns != 1)) ||
          al > 13)
        fail("corrupt progressive scan parameters (SOS)");
    }
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      c->td = tables[i] >> 4;
      c->ta = tables[i] & 15;
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if (c->td > 3 || c->ta > 3 || (need_dc && !dc[c->td].defined) ||
          (need_ac && !ac[c->ta].defined))
        fail("SOS uses an undefined Huffman table");
      if (!c->latched) {  // libjpeg latches the table at the first scan
        if (!qdef[c->tq]) fail("a component's quantization table is missing");
        for (int k = 0; k < 64; k++) c->quant[k] = (int16_t)qtab[c->tq][k];
        c->latched = true;
        c->plane.assign((size_t)c->stride * c->rows, 0);
        if (progressive) {
          c->coef.assign((size_t)c->stride * c->rows, 0);
          for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
        }
      }
      if (progressive)  // libjpeg only warns about a scan out of order
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      c->pred = 0;
      c->decoded = true;
    }
    eobrun = 0;
    Bits bits{data + pos, data + n};
    int16_t block[64];
    auto one_block = [&](Component* c, int bx, int by) {
      std::memset(block, 0, sizeof block);
      const Huff& hd = dc[c->td];
      const Huff& ha = ac[c->ta];
      int s = decode_sym(bits, hd);
      if (s) c->pred += extend(bits.get(s), s);
      block[0] = (int16_t)c->pred;
      for (int k = 1; k < 64; k++) {
        int rs = decode_sym(bits, ha);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          block[kNatural[k]] = (int16_t)extend(bits.get(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      idct_islow(block, c->quant,
                 c->plane.data() + (size_t)by * 8 * c->stride + bx * 8,
                 c->stride);
    };
    auto prog_block = [&](Component* c, int bx, int by) {
      int16_t* b = c->coef.data() + ((size_t)by * (c->stride / 8) + bx) * 64;
      if (ss == 0) {
        decode_dc(bits, c, b, ah, al);
      } else if (ah == 0) {
        decode_ac_first(bits, ac[c->ta], b, ss, se, al);
      } else {
        decode_ac_refine(bits, ac[c->ta], b, ss, se, al);
      }
    };
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcus_x;
      units_y = mcus_y;
    }
    int todo = restart_interval;
    for (int my = 0; my < units_y; my++) {
      for (int mx = 0; mx < units_x; mx++) {
        if (restart_interval) {
          if (todo == 0) {
            restart(bits);
            for (int i = 0; i < ns; i++) sc[i]->pred = 0;
            eobrun = 0;
            todo = restart_interval;
          }
          todo--;
        }
        for (int i = 0; i < ns; i++) {
          int bh = ns == 1 ? 1 : sc[i]->h, bv = ns == 1 ? 1 : sc[i]->v;
          for (int y = 0; y < bv; y++)
            for (int x = 0; x < bh; x++) {
              int bx = mx * bh + x, by = my * bv + y;
              if (progressive) prog_block(sc[i], bx, by);
              else one_block(sc[i], bx, by);
            }
        }
      }
    }
    pos = (size_t)(bits.p - data);
  }

  // ---- jdphuff.c ----
  // DC first (ah 0: the difference, shifted up by al) or refine (one bit).
  void decode_dc(Bits& bits, Component* c, int16_t* b, int ah, int al) {
    if (ah == 0) {
      int s = decode_sym(bits, dc[c->td]);
      if (s) c->pred += extend(bits.get(s), s);
      b[0] = (int16_t)((unsigned)c->pred << al);
    } else if (bits.get(1)) {
      b[0] = (int16_t)(b[0] | (1 << al));
    }
  }

  // AC first: coefficients ss..se shifted up by al, or a band of blocks
  // ended early (EOBRUN).
  void decode_ac_first(Bits& bits, const Huff& t, int16_t* b, int ss, int se,
                       int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode_sym(bits, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        b[kNatural[k]] = (int16_t)((unsigned)extend(bits.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += bits.get(r);
        break;
      }
    }
  }

  // AC refine: one more bit of every nonzero coefficient in ss..se, and
  // coefficients that become nonzero (+-1 << al) after runs of zeros.
  void decode_ac_refine(Bits& bits, const Huff& t, int16_t* b, int ss,
                        int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t* coef) {
      if (bits.get(1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_sym(bits, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = b + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  // The IDCT of every block of a progressive file, once its scans are
  // read; every coefficient must have been refined to its last bit.
  void finish_progressive() {
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!c.latched) continue;
      for (int k = 0; k < 64; k++)
        if (c.coef_bits[k] != 0)
          fail("a progressive file whose scans leave coefficient bits "
               "undecoded");
      const int bw = c.stride / 8, bh = c.rows / 8;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++)
          idct_islow(c.coef.data() + ((size_t)by * bw + bx) * 64, c.quant,
                     c.plane.data() + (size_t)by * 8 * c.stride + bx * 8,
                     c.stride);
    }
  }

  // Drop the buffered bits and read the RSTn marker at the reader's place.
  void restart(Bits& bits) {
    const uint8_t* p = bits.p;
    const uint8_t* end = data + n;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
      p++;
    if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
    bits.p = p;
    bits.reset();
  }

  // ---- jdsample.c ----
  // Component ``c`` upsampled to width x height into ``out``.
  void upsample(const Component& c, uint8_t* out) const {
    const int W = width, H = height;
    const int hx = hmax / c.h, vx = vmax / c.v;
    const uint8_t* src = c.plane.data();
    const int s = c.stride;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return src + (size_t)r * s;
    };
    std::vector<uint8_t> line((size_t)2 * c.dw + 16);
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < H; y++) std::memcpy(out + (size_t)y * W, row(y), W);
    } else if (hx == 2 && vx == 1 && c.dw > 2) {
      for (int y = 0; y < H; y++) {
        const uint8_t* in = row(y);
        uint8_t* o = line.data();
        int v = in[0];
        *o++ = (uint8_t)v;
        *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          v = in[x] * 3;
          *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
          *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        v = in[c.dw - 1];
        *o++ = (uint8_t)((v * 3 + in[c.dw - 2] + 1) >> 2);
        *o++ = (uint8_t)v;
        std::memcpy(out + (size_t)y * W, line.data(), W);
      }
    } else if (hx == 1 && vx == 2) {
      for (int y = 0; y < H; y++) {
        int r = y >> 1, v = y & 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row(v ? r + 1 : r - 1);
        int bias = v ? 2 : 1;
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; x++)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && c.dw > 2) {
      for (int y = 0; y < H; y++) {
        int r = y >> 1, v = y & 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row(v ? r + 1 : r - 1);
        uint8_t* o = line.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < c.dw; x++) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
        std::memcpy(out + (size_t)y * W, line.data(), W);
      }
    } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
      for (int y = 0; y < H; y++) {
        // replication reads the padded plane, as libjpeg's does
        const uint8_t* in = src + (size_t)(y / vx) * s;
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; x++) o[x] = in[x / hx];
      }
    }
  }

  // The output pixels: 3 channels RGB, or 1 channel (libjpeg's
  // JCS_GRAYSCALE).
  void output(bool gray, uint8_t* out) const {
    const size_t np = (size_t)width * height;
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].decoded) fail("a component has no scan");
    if (ncomp == 1) {
      std::vector<uint8_t> y(np);
      upsample(comp[0], y.data());
      if (gray) {
        std::memcpy(out, y.data(), np);
      } else {
        for (size_t i = 0; i < np; i++)
          out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    // jdapimin.c default_decompress_parms for 3 components
    bool rgb = false;
    if (!jfif && adobe) {
      rgb = adobe_transform == 0;
    } else if (!jfif && !adobe) {
      rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    if (gray && !rgb) {  // grayscale_convert: the Y plane
      upsample(comp[0], out);
      return;
    }
    std::vector<uint8_t> p0(np), p1(np), p2(np);
    upsample(comp[0], p0.data());
    upsample(comp[1], p1.data());
    upsample(comp[2], p2.data());
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    if (gray) {  // rgb_gray_convert
      const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
      for (size_t i = 0; i < np; i++)
        out[i] = (uint8_t)((ry * p0[i] + gy * p1[i] + by * p2[i] + one_half) >>
                           16);
      return;
    }
    if (rgb) {
      for (size_t i = 0; i < np; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // ycc_rgb_convert with build_ycc_rgb_table's tables
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < np; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void copy_err(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// info: width, height, components (1 or 3), EXIF orientation (1-8)
int casmtr_jpeg_header(const uint8_t* data, size_t n, int* info, char* err,
                       int errlen) {
  try {
    Decoder d(data, n);
    d.run(false);
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Refused& e) {
    copy_err(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, errlen);
    return 1;
  }
}

// out: height x width x (gray ? 1 : 3) uint8, before the EXIF orientation
int casmtr_jpeg_decode(const uint8_t* data, size_t n, int gray, uint8_t* out,
                       char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.run(true);
    d.output(gray != 0, out);
    return 0;
  } catch (const Refused& e) {
    copy_err(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
