// PNG pixel decoder with no library, with a plain C interface bound through
// ctypes (harp_tpu_torch/native/__init__.py, png_pixels). It takes the
// image data already inflated (Python's zlib does that) and undoes the
// five row filters (None, Sub, Up, Average, Paeth) and the Adam7
// interlace, unpacking samples of 1, 2, 4, 8 or 16 bits.
//
//   hp_decode(raw, n, w, h, depth, channels, interlace, out) -> status
//
// raw: n inflated bytes, each (pass) row led by its filter type byte.
// channels: samples a pixel (1 grey or palette index, 2 grey + alpha,
// 3 RGB, 4 RGBA). out: h * w * channels samples, uint8 for depth <= 8
// (the sample's value, 0 .. 2^depth - 1, not scaled) or uint16 for 16.
// Status: 0, 1 if raw is shorter than the image needs, 2 + the filter
// type if a row has an unknown one. Bytes past the image are ignored.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Pass {
  int x0, y0, dx, dy;
};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                        {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
const Pass kWhole = {0, 0, 1, 1};

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return static_cast<uint8_t>(pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
}

// Undo one row's filter in place; prev is the previous row of the pass
// (zeros for its first row), bpp the bytes a pixel (at least 1).
bool unfilter(int type, uint8_t* cur, const uint8_t* prev, long len, int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (long i = bpp; i < len; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (long i = 0; i < len; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
      return true;
    case 3:
      for (long i = 0; i < bpp && i < len; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + (prev[i] >> 1));
      for (long i = bpp; i < len; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:
      for (long i = 0; i < bpp && i < len; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
      for (long i = bpp; i < len; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int hp_decode(const uint8_t* raw, long n, int w, int h, int depth, int channels,
                         int interlace, void* out) {
  const int bits = depth * channels, bpp = bits >= 8 ? bits / 8 : 1;
  const int npass = interlace ? 7 : 1;
  uint8_t* out8 = static_cast<uint8_t*>(out);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  long pos = 0;
  std::vector<uint8_t> prev, cur;
  for (int p = 0; p < npass; ++p) {
    const Pass ps = interlace ? kAdam7[p] : kWhole;
    const int pw = w > ps.x0 ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    const int ph = h > ps.y0 ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows at all
    const long len = (static_cast<long>(pw) * bits + 7) / 8;
    prev.assign(len, 0);
    cur.resize(len);
    for (int r = 0; r < ph; ++r) {
      if (pos + 1 + len > n) return 1;
      const int type = raw[pos];
      std::memcpy(cur.data(), raw + pos + 1, len);
      pos += 1 + len;
      if (!unfilter(type, cur.data(), prev.data(), len, bpp)) return 2 + type;
      const long y = ps.y0 + static_cast<long>(r) * ps.dy;
      for (int i = 0; i < pw; ++i) {
        const long x = ps.x0 + static_cast<long>(i) * ps.dx;
        const long o = (y * w + x) * channels;
        for (int c = 0; c < channels; ++c) {
          const long s = static_cast<long>(i) * channels + c;  // sample index in the row
          if (depth == 16) {
            out16[o + c] = static_cast<uint16_t>((cur[2 * s] << 8) | cur[2 * s + 1]);
          } else if (depth == 8) {
            out8[o + c] = cur[s];
          } else {  // samples packed from the most significant bit
            const long bit = s * depth;
            out8[o + c] = static_cast<uint8_t>((cur[bit >> 3] >> (8 - depth - (bit & 7))) &
                                               ((1 << depth) - 1));
          }
        }
      }
      prev.swap(cur);
      cur.resize(len);
    }
  }
  return 0;
}
