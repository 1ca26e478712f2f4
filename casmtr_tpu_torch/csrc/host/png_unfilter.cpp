// PNG row unfiltering (the specification's filter types 0-4: None, Sub, Up,
// Average, Paeth) for any bytes per pixel.  The caller inflates the joined
// IDAT chunks with zlib and reads the samples.  Plain C interface (ctypes).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {

// raw: height rows of (1 filter byte + rowbytes); out: height x rowbytes.
// Returns 0, or 1 with a message in ``err`` for an unknown filter type.
int casmtr_png_unfilter(const uint8_t* raw, int height, int rowbytes,
                        int bpp, uint8_t* out, char* err, int errlen) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; y++) {
    const uint8_t* in = raw + (size_t)y * (rowbytes + 1);
    const int type = in[0];
    in++;
    uint8_t* o = out + (size_t)y * rowbytes;
    switch (type) {
      case 0:
        for (int i = 0; i < rowbytes; i++) o[i] = in[i];
        break;
      case 1:
        for (int i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        if (err && errlen > 0)
          std::snprintf(err, errlen, "unknown PNG filter type %d in row %d",
                        type, y);
        return 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
