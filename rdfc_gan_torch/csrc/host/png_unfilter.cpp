// PNG row unfiltering (PNG specification, section 9: filter types 0-4),
// host code with a plain C interface, loaded with ctypes by
// rdfc_gan_torch/data/image_io.py. It is the one sequential part of a PNG
// decode: the Sub, Average and Paeth filters make each byte depend on the
// byte bpp to its left, so the loop runs byte by byte.

#include <cstdint>
#include <cstdlib>

extern "C" {

// src: height rows of 1 + rowbytes bytes (the filter byte, then the
// filtered row), as inflated from the IDAT stream. dst: height * rowbytes
// bytes of unfiltered rows. bpp: bytes per complete pixel, at least 1.
// Returns 0, or 1 + the index of the first row whose filter byte is not
// 0-4 (rows before it are unfiltered, the rest are left as they were).
long long png_unfilter(const uint8_t* src, uint8_t* dst, long long height,
                       long long rowbytes, int bpp) {
  const uint8_t* prior = nullptr;
  for (long long y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const uint8_t filter = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    switch (filter) {
      case 0:
        for (long long i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (long long i = 0; i < rowbytes; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (long long i = 0; i < rowbytes; ++i)
          out[i] = uint8_t(in[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < rowbytes; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          const int up = prior ? prior[i] : 0;
          out[i] = uint8_t(in[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = uint8_t(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prior = out;
  }
  return 0;
}

}  // extern "C"
