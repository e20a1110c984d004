// Baseline JPEG encoder and decoder with no library, with a plain C
// interface bound through ctypes (harp_tpu_torch/native/__init__.py).
//
// Both reproduce libjpeg(-turbo)'s integer arithmetic at its default
// settings, so that a file is the same bytes and a decode the same pixels
// on any machine, whether libjpeg is installed there or not:
//
// - the encoder writes what Pillow's Image.save(path, quality=q) writes
//   (jpeg_set_defaults + jpeg_set_quality(q, TRUE)): JFIF, 4:2:0 YCbCr for
//   colour and one component for grey, the standard Huffman tables, the
//   accurate integer DCT (jfdctint.c), libjpeg's colour conversion
//   (jccolor.c), h2v2 downsampling with its alternating bias (jcsample.c),
//   its edge padding and dummy blocks (jcprepct.c, jccoefct.c);
// - the decoder reads a baseline or extended sequential Huffman JPEG of 8
//   bits, 1 or 3 components, as libjpeg decodes it by default: the accurate
//   integer IDCT (jidctint.c) with its range limit table, fancy upsampling
//   (jdsample.c, with jdmainct.c's context rows at the image's edges) and
//   YCbCr to RGB through jdcolor.c's tables. Progressive, arithmetic,
//   12-bit and 4-component files are refused.
//
//   hj_encode(pixels, h, w, channels, quality, out, cap) -> bytes, or -1 if
//       cap is too short
//   hj_info(data, n, &h, &w, &channels, err, errcap)     -> 0 or -1
//   hj_decode(data, n, out, h, w, channels, err, errcap) -> 0 or -1
//
// pixels / out: h * w * channels uint8, channels 1 (grey) or 3 (RGB).
// On -1 the decoder writes the reason into err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // overrun guard

const int kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The standard Huffman tables (ITU T.81 annex K.3): 16 code counts, then
// the values.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jfdctint.c / jidctint.c constants (CONST_BITS 13).
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                  F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// Canonical Huffman codes of (bits, vals), as jpeg_make_c_derived_tbl.
void make_codes(const uint8_t* bits, const uint8_t* vals, uint16_t* code, uint8_t* size) {
  int p = 0, c = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      code[vals[p]] = static_cast<uint16_t>(c++);
      size[vals[p]] = static_cast<uint8_t>(l);
    }
    c <<= 1;
  }
}

// ---------------------------------------------------------------- encoder

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);  // byte stuffing
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {  // pad the last byte with ones (jchuff.c flush_bits)
    put(0x7F, 7);
    acc = 0;
    nbits = 0;
  }
};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int r = 0; r < 8; ++r) {
      int32_t* p = d + r * stride;
      const int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      const int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      const int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      const int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) << kPass1Bits;
        p[4 * step] = (tmp10 - tmp11) << kPass1Bits;
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = descale(z1 + tmp13 * F0_765, sh);
      p[6 * step] = descale(z1 + tmp12 * (-F1_847), sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * F1_175;
      const int32_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053, t6 = tmp6 * F3_072,
                    t7 = tmp7 * F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * (-F1_961) + z5;
      z4 = z4 * (-F0_390) + z5;
      p[7 * step] = descale(t4 + z1 + z3, sh);
      p[5 * step] = descale(t5 + z2 + z4, sh);
      p[3 * step] = descale(t6 + z2 + z3, sh);
      p[step] = descale(t7 + z1 + z4, sh);
    }
  }
}

// One 8x8 block of plane (stride w) at (y0, x0): level shift, DCT,
// quantisation by divisor q * 8 rounded half away from zero.
void encode_block_coefs(const uint8_t* plane, int stride, int y0, int x0, const int* q,
                        int32_t* coef) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = plane[(y0 + y) * stride + x0 + x] - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    const int32_t qv = q[i] << 3;
    int32_t t = d[i];
    if (t < 0) {
      t = -t + (qv >> 1);
      t = t >= qv ? t / qv : 0;
      t = -t;
    } else {
      t += qv >> 1;
      t = t >= qv ? t / qv : 0;
    }
    coef[i] = t;
  }
}

void emit_block(BitWriter& bw, const int32_t* c, int32_t& last_dc, const HuffEnc& dc,
                const HuffEnc& ac) {
  int32_t t = c[0] - last_dc, t2 = t;
  last_dc = c[0];
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = 0;
  while (t) {
    ++nb;
    t >>= 1;
  }
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(t2), nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    t = c[kNatural[k]];
    if (t == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      --t2;
    }
    nb = 1;
    while ((t >>= 1)) ++nb;
    const int sym = (r << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2), nb);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dqt(std::vector<uint8_t>& o, int index, const int* q) {
  o.insert(o.end(), {0xFF, 0xDB});
  put16(o, 67);
  o.push_back(static_cast<uint8_t>(index));
  for (int i = 0; i < 64; ++i) o.push_back(static_cast<uint8_t>(q[kNatural[i]]));
}

void put_dht(std::vector<uint8_t>& o, int cls_index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.insert(o.end(), {0xFF, 0xC4});
  put16(o, 19 + n);
  o.push_back(static_cast<uint8_t>(cls_index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

// The table jpeg_set_quality(quality, force_baseline=TRUE) makes of base.
void scaled_table(const int* base, int quality, int* q) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50) / 100;
    q[i] = static_cast<int>(t <= 0 ? 1 : (t > 255 ? 255 : t));
  }
}

// A plane of ph x pw samples from src (h x w), the edges replicated.
std::vector<uint8_t> padded(const uint8_t* src, int h, int w, int ph, int pw) {
  std::vector<uint8_t> out(static_cast<size_t>(ph) * pw);
  for (int y = 0; y < ph; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y < h ? y : h - 1) * w;
    uint8_t* dst = out.data() + static_cast<size_t>(y) * pw;
    for (int x = 0; x < pw; ++x) dst[x] = row[x < w ? x : w - 1];
  }
  return out;
}

long encode(const uint8_t* px, int h, int w, int ch, int quality, uint8_t* dst, long cap) {
  int qy[64], qc[64];
  scaled_table(kStdLumaQ, quality, qy);
  scaled_table(kStdChromaQ, quality, qc);
  HuffEnc dcy, acy, dcc, acc;
  make_codes(kDcLumaBits, kDcVals, dcy.code, dcy.size);
  make_codes(kAcLumaBits, kAcLumaVals, acy.code, acy.size);
  make_codes(kDcChromaBits, kDcVals, dcc.code, dcc.size);
  make_codes(kAcChromaBits, kAcChromaVals, acc.code, acc.size);

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(h) * w * ch / 4 + 1024);
  o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                     0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
  put_dqt(o, 0, qy);
  if (ch == 3) put_dqt(o, 1, qc);
  o.insert(o.end(), {0xFF, 0xC0});
  put16(o, 8 + 3 * ch);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(ch));
  if (ch == 3) {
    o.insert(o.end(), {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  } else {
    o.insert(o.end(), {1, 0x11, 0});
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (ch == 3) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  o.insert(o.end(), {0xFF, 0xDA});
  put16(o, 6 + 2 * ch);
  o.push_back(static_cast<uint8_t>(ch));
  if (ch == 3) {
    o.insert(o.end(), {1, 0x00, 2, 0x11, 3, 0x11});
  } else {
    o.insert(o.end(), {1, 0x00});
  }
  o.insert(o.end(), {0, 63, 0});

  BitWriter bw{o};
  int32_t coef[6][64];
  if (ch == 1) {
    const int bw8 = (w + 7) / 8, bh8 = (h + 7) / 8;
    const std::vector<uint8_t> g = padded(px, h, w, bh8 * 8, bw8 * 8);
    int32_t last = 0;
    for (int by = 0; by < bh8; ++by)
      for (int bx = 0; bx < bw8; ++bx) {
        encode_block_coefs(g.data(), bw8 * 8, by * 8, bx * 8, qy, coef[0]);
        emit_block(bw, coef[0], last, dcy, acy);
      }
  } else {
    // jccolor.c rgb_ycc_convert, SCALEBITS 16.
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
    const int32_t half = 1 << 15, cbcr_off = 128 << 16;
    std::vector<uint8_t> plane[3];
    for (auto& p : plane) p.resize(static_cast<size_t>(h) * w);
    for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i) {
      const int32_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      plane[0][i] = static_cast<uint8_t>((fix(0.29900) * r + fix(0.58700) * g +
                                          fix(0.11400) * b + half) >> 16);
      plane[1][i] = static_cast<uint8_t>((-fix(0.16874) * r - fix(0.33126) * g +
                                          fix(0.50000) * b + cbcr_off + half - 1) >> 16);
      plane[2][i] = static_cast<uint8_t>((fix(0.50000) * r - fix(0.41869) * g -
                                          fix(0.08131) * b + cbcr_off + half - 1) >> 16);
    }
    const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    const int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
    const std::vector<uint8_t> Y = padded(plane[0].data(), h, w, mcuy * 16, mcux * 16);
    // jcsample.c h2v2_downsample over the right-padded rows of the
    // colour buffer (bias 1, 2, 1, 2, ... along each row); jcprepct.c
    // pads an odd last row by repeating it, and the rows below the
    // image's by repeating the last downsampled row.
    const int cw = mcux * 8, chh = (h + 1) / 2, cph = mcuy * 8;
    std::vector<uint8_t> C[2];
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t> full = padded(plane[c + 1].data(), h, w, 2 * chh, 2 * cw);
      C[c].resize(static_cast<size_t>(cph) * cw);
      for (int y = 0; y < cph; ++y) {
        const int sy = y < chh ? y : chh - 1;
        const uint8_t* r0 = full.data() + static_cast<size_t>(2 * sy) * 2 * cw;
        const uint8_t* r1 = r0 + 2 * cw;
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          C[c][static_cast<size_t>(y) * cw + x] =
              static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
                                    bias) >> 2);
          bias ^= 3;
        }
      }
    }
    int32_t last[3] = {0, 0, 0};
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        // jccoefct.c: a block right of the component's last block column
        // is a dummy with the previous block's DC; a block row below its
        // last block row, dummies with the DC of the MCU's block before.
        for (int k = 0; k < 4; ++k) {
          const int by = 2 * my + k / 2, bx = 2 * mx + k % 2;
          if (by < yhib && bx < ywib) {
            encode_block_coefs(Y.data(), mcux * 16, by * 8, bx * 8, qy, coef[k]);
          } else {
            std::memset(coef[k], 0, sizeof(coef[k]));
            coef[k][0] = coef[by < yhib ? k - 1 : (k / 2) * 2 - 1][0];
          }
        }
        for (int c = 0; c < 2; ++c)
          encode_block_coefs(C[c].data(), cw, my * 8, mx * 8, qc, coef[4 + c]);
        for (int k = 0; k < 4; ++k) emit_block(bw, coef[k], last[0], dcy, acy);
        emit_block(bw, coef[4], last[1], dcc, acc);
        emit_block(bw, coef[5], last[2], dcc, acc);
      }
  }
  bw.flush();
  o.insert(o.end(), {0xFF, 0xD9});
  if (static_cast<long>(o.size()) > cap) return -1;
  std::memcpy(dst, o.data(), o.size());
  return static_cast<long>(o.size());
}

// ---------------------------------------------------------------- decoder

struct Fail {
  std::string why;
};

struct HuffDec {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;  // blocks across and down in the plane
  int dw = 0, dh = 0;  // downsampled width and height (jdinput.c)
  std::vector<uint8_t> plane;
  bool seen = false;
  int q[64];
};

struct Decoder {
  Decoder(const uint8_t* data, long size) : d(data), n(size) {}
  const uint8_t* d;
  long n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart = 0;
  int qt[4][64];
  bool qt_def[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  Component comp[3];
  // Entropy reader state.
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  int byte() {
    if (pos >= n) throw Fail{"the JPEG data ends early"};
    return d[pos++];
  }
  int u16() {
    const int a = byte();
    return (a << 8) | byte();
  }

  void read_dqt(long end) {
    while (pos < end) {
      const int pq = byte(), t = pq & 15;
      if (t > 3) throw Fail{"a quantisation table has index > 3"};
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = (pq >> 4) ? u16() : byte();
      qt_def[t] = true;
    }
  }

  void read_dht(long end) {
    while (pos < end) {
      const int tc = byte(), cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) throw Fail{"a Huffman table has a bad class or index"};
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = static_cast<uint8_t>(byte());
      if (total > 256) throw Fail{"a Huffman table has more than 256 codes"};
      HuffDec& hd = cls ? ac[t] : dc[t];
      for (int i = 0; i < total; ++i) hd.vals[i] = static_cast<uint8_t>(byte());
      // jdhuff.c jpeg_make_d_derived_tbl.
      int p = 0, code = 0;
      for (int l = 1; l <= 16; ++l) {
        if (bits[l]) {
          hd.valoffset[l] = p - code;
          p += bits[l];
          code += bits[l];
          hd.maxcode[l] = code - 1;
        } else {
          hd.maxcode[l] = -1;
        }
        code <<= 1;
      }
      hd.maxcode[17] = 0x7FFFFFFF;
      hd.defined = true;
    }
  }

  void read_sof(int marker) {
    if (marker != 0xC0 && marker != 0xC1) {
      char m[8];
      std::snprintf(m, sizeof(m), "%02X", marker);
      throw Fail{std::string("not a baseline or extended sequential Huffman JPEG (SOF marker "
                             "0xFF") + m + "): progressive, lossless and arithmetic-coded "
                 "files are not read"};
    }
    if (have_frame) throw Fail{"two frame headers"};
    if (byte() != 8) throw Fail{"a JPEG of other than 8 bits a sample"};
    height = u16();
    width = u16();
    ncomp = byte();
    if (width <= 0 || height <= 0) throw Fail{"a JPEG of no pixels"};
    if (ncomp != 1 && ncomp != 3) throw Fail{"a JPEG of other than 1 or 3 components"};
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = byte();
      const int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        throw Fail{"a component has bad sampling factors or table"};
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (hmax % k.h || vmax % k.v) throw Fail{"non-integral sampling ratios"};
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = static_cast<int>((static_cast<long>(width) * k.h + hmax - 1) / hmax);
      k.dh = static_cast<int>((static_cast<long>(height) * k.v + vmax - 1) / vmax);
    }
    have_frame = true;
  }

  // Entropy-coded bits: 0xFF 0x00 is a data byte 0xFF; a marker stops the
  // reader, which then feeds zeros (jdhuff.c).
  void fill() {
    while (bitcnt <= 24) {
      int b = 0;
      if (!hit_marker) {
        if (pos >= n) throw Fail{"the JPEG data ends early"};
        b = d[pos];
        if (b == 0xFF) {
          long p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p >= n) throw Fail{"the JPEG data ends early"};
          if (d[p] == 0) {
            pos = p + 1;
          } else {
            hit_marker = true;
            pos = p - 1;  // at the marker's last 0xFF
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bitbuf |= static_cast<uint32_t>(b) << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    const int v = static_cast<int>(bitbuf >> (32 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }
  int decode(const HuffDec& t) {
    int code = bits(1), l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      if (++l > 16) return 0;  // corrupt: libjpeg warns and decodes a zero
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void decode_block(Component& k, int by, int bx, int& pred) {
    int32_t c[64] = {0};
    const int s = decode(dc[k.dc_tbl]);
    pred += s ? extend(bits(s), s) : 0;
    c[0] = pred;
    for (int i = 1; i < 64; ++i) {
      const int rs = decode(ac[k.ac_tbl]), r = rs >> 4, sz = rs & 15;
      if (sz) {
        i += r;
        c[kNatural[i]] = extend(bits(sz), sz);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    idct_islow(c, k.q, k.plane.data() + static_cast<size_t>(by) * 8 * k.bw * 8 + bx * 8,
               k.bw * 8);
  }

  static uint8_t range_limit(int32_t x) {
    // jdmaster.c prepare_range_limit_table, as the IDCT indexes it:
    // table[x & 1023] past CENTERJSAMPLE.
    x &= 1023;
    if (x < 128) return static_cast<uint8_t>(x + 128);
    if (x < 512) return 255;
    if (x < 896) return 0;
    return static_cast<uint8_t>(x - 896);
  }

  static void idct_islow(const int32_t* in, const int* q, uint8_t* out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; ++c) {
      const int32_t* ip = in + c;
      const int* qp = q + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int32_t dcval = (ip[0] * qp[0]) * (1 << kPass1Bits);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
        continue;
      }
      int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int32_t z1 = (z2 + z3) * F0_541;
      int32_t tmp2 = z1 + z3 * (-F1_847), tmp3 = z1 + z2 * F0_765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int32_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int32_t z4 = tmp1 + tmp3;
      const int32_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * (-F1_961) + z5;
      z4 = z4 * (-F0_390) + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      ws[0 * 8 + c] = descale(tmp10 + tmp3, sh);
      ws[7 * 8 + c] = descale(tmp10 - tmp3, sh);
      ws[1 * 8 + c] = descale(tmp11 + tmp2, sh);
      ws[6 * 8 + c] = descale(tmp11 - tmp2, sh);
      ws[2 * 8 + c] = descale(tmp12 + tmp1, sh);
      ws[5 * 8 + c] = descale(tmp12 - tmp1, sh);
      ws[3 * 8 + c] = descale(tmp13 + tmp0, sh);
      ws[4 * 8 + c] = descale(tmp13 - tmp0, sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int32_t* w = ws + r * 8;
      uint8_t* o = out + static_cast<size_t>(r) * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        const uint8_t v = range_limit(descale(w[0], kPass1Bits + 3));
        for (int x = 0; x < 8; ++x) o[x] = v;
        continue;
      }
      int32_t z2 = w[2], z3 = w[6];
      int32_t z1 = (z2 + z3) * F0_541;
      int32_t tmp2 = z1 + z3 * (-F1_847), tmp3 = z1 + z2 * F0_765;
      int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits), tmp1 = (w[0] - w[4]) * (1 << kConstBits);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int32_t z4 = tmp1 + tmp3;
      const int32_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * (-F1_961) + z5;
      z4 = z4 * (-F0_390) + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits + kPass1Bits + 3;
      o[0] = range_limit(descale(tmp10 + tmp3, sh));
      o[7] = range_limit(descale(tmp10 - tmp3, sh));
      o[1] = range_limit(descale(tmp11 + tmp2, sh));
      o[6] = range_limit(descale(tmp11 - tmp2, sh));
      o[2] = range_limit(descale(tmp12 + tmp1, sh));
      o[5] = range_limit(descale(tmp12 - tmp1, sh));
      o[3] = range_limit(descale(tmp13 + tmp0, sh));
      o[4] = range_limit(descale(tmp13 - tmp0, sh));
    }
  }

  // At a restart interval's end: drop the buffered bits, step over RSTn,
  // reset the predictions (jdhuff.c process_restart).
  void restart_interval(int* pred) {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before the marker
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n || d[pos] < 0xD0 || d[pos] > 0xD7) throw Fail{"a restart marker is missing"};
    ++pos;
    for (int c = 0; c < 3; ++c) pred[c] = 0;
  }

  void read_scan() {
    if (!have_frame) throw Fail{"a scan before the frame header"};
    for (int c = 0; c < ncomp; ++c)  // the planes, made at the first scan
      if (comp[c].plane.empty())
        comp[c].plane.assign(static_cast<size_t>(comp[c].bw) * 8 * comp[c].bh * 8, 0);
    const int ns = byte();
    if (ns < 1 || ns > ncomp) throw Fail{"a scan with a bad component count"};
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      Component* k = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) k = &comp[c];
      if (!k) throw Fail{"a scan names an unknown component"};
      k->dc_tbl = t >> 4;
      k->ac_tbl = t & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3 || !dc[k->dc_tbl].defined || !ac[k->ac_tbl].defined)
        throw Fail{"a scan uses an undefined Huffman table"};
      if (!k->seen) {  // jdinput.c latch_quant_tables: the table at the first scan
        if (!qt_def[k->tq]) throw Fail{"a component uses an undefined quantisation table"};
        std::memcpy(k->q, qt[k->tq], sizeof(k->q));
        k->seen = true;
      }
      sc[i] = k;
    }
    const int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Fail{"a progressive scan"};
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    int pred[3] = {0, 0, 0};
    int todo = restart;
    if (ns == 1) {
      Component& k = *sc[0];
      const int bw = (k.dw + 7) / 8, bh = (k.dh + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          if (restart && todo == 0) {
            restart_interval(pred);
            todo = restart;
          }
          decode_block(k, by, bx, pred[0]);
          --todo;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart && todo == 0) {
            restart_interval(pred);
            todo = restart;
          }
          for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            for (int y = 0; y < k.v; ++y)
              for (int x = 0; x < k.h; ++x) decode_block(k, my * k.v + y, mx * k.h + x, pred[i]);
          }
          --todo;
        }
    }
    // Step to the marker after the entropy data.
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF &&
                            !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Fail{"not a JPEG file (no SOI marker)"};
    pos = 2;
    for (;;) {
      if (pos >= n) throw Fail{"the JPEG data ends before its EOI marker"};
      if (d[pos] != 0xFF) {
        ++pos;  // libjpeg skips stray bytes between markers, with a warning
        continue;
      }
      while (pos < n && d[pos] == 0xFF) ++pos;
      const int m = byte();
      if (m == 0xD9) {
        if (!have_frame) throw Fail{"a JPEG without a frame"};
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;
      const long len = u16(), end = pos + len - 2;
      if (len < 2 || end > n) throw Fail{"a JPEG marker segment runs past the data"};
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
        if (header_only) return;
      } else if (m == 0xDA) {
        read_scan();
        continue;
      } else if (m == 0xE0 && len >= 16 && std::memcmp(d + pos, "JFIF\0", 5) == 0) {
        jfif = true;
      } else if (m == 0xEE && len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = d[pos + 11];
      }
      pos = end;
    }
  }

  // jdsample.c and jdmainct.c: component k upsampled to the image's size,
  // rows above the first and below the last real row replicating them.
  std::vector<uint8_t> upsample(const Component& k) const {
    const int he = hmax / k.h, ve = vmax / k.v, stride = k.bw * 8;
    std::vector<uint8_t> out(static_cast<size_t>(height) * width);
    const uint8_t* p = k.plane.data();
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= k.dh ? k.dh - 1 : r);
      return p + static_cast<size_t>(r) * stride;
    };
    const bool fancy_h2 = he == 2 && k.dw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + static_cast<size_t>(y) * width;
      const int r = y / ve;
      if (he == 1 && ve == 1) {
        std::memcpy(o, row(r), width);
      } else if (fancy_h2 && ve == 1) {  // h2v1_fancy_upsample
        const uint8_t* in = row(r);
        std::vector<uint8_t> t(2 * k.dw);
        t[0] = in[0];
        t[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < k.dw - 1; ++x) {
          const int v = in[x] * 3;
          t[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          t[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        const int l = k.dw - 1;
        t[2 * l] = static_cast<uint8_t>((in[l] * 3 + in[l - 1] + 1) >> 2);
        t[2 * l + 1] = in[l];
        std::memcpy(o, t.data(), width);
      } else if (fancy_h2 && ve == 2) {  // h2v2_fancy_upsample
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row(y % 2 ? r + 1 : r - 1);
        std::vector<uint8_t> t(2 * k.dw);
        int this_sum = in0[0] * 3 + in1[0], next_sum = in0[1] * 3 + in1[1], last_sum;
        t[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        t[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < k.dw - 1; ++x) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          t[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          t[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        const int l = k.dw - 1;
        t[2 * l] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        t[2 * l + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(o, t.data(), width);
      } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row(y % 2 ? r + 1 : r - 1);
        const int bias = y % 2 ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
        const uint8_t* in = row(r);
        for (int x = 0; x < width; ++x) o[x] = in[x / he];
      }
    }
    return out;
  }

  // The image as ncomp channels: grey, or RGB.
  void output(uint8_t* out) const {
    const size_t npx = static_cast<size_t>(height) * width;
    if (ncomp == 1) {
      const std::vector<uint8_t> g = upsample(comp[0]);
      std::memcpy(out, g.data(), npx);
      return;
    }
    bool ycc = true;  // jdapimin.c default_decompress_parms
    if (!jfif) {
      if (adobe) {
        ycc = adobe_transform != 0;
      } else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) {
        ycc = false;
      }
    }
    const std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]),
                               p2 = upsample(comp[2]);
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < npx; ++i) {
      int r = p0[i], g = p1[i], b = p2[i];
      if (ycc) {  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
        const int y = p0[i], cb = p1[i] - 128, cr = p2[i] - 128;
        r = clamp(y + ((fix(1.40200) * cr + (1 << 15)) >> 16));
        g = clamp(y + ((-fix(0.34414) * cb + (1 << 15) - fix(0.71414) * cr) >> 16));
        b = clamp(y + ((fix(1.77200) * cb + (1 << 15)) >> 16));
      }
      out[3 * i] = static_cast<uint8_t>(r);
      out[3 * i + 1] = static_cast<uint8_t>(g);
      out[3 * i + 2] = static_cast<uint8_t>(b);
    }
  }
};

void set_err(char* err, int cap, const std::string& why) {
  if (cap > 0) std::snprintf(err, cap, "%s", why.c_str());
}

}  // namespace

extern "C" {

long hj_encode(const uint8_t* pixels, int h, int w, int channels, int quality, uint8_t* out,
               long cap) {
  return encode(pixels, h, w, channels, quality, out, cap);
}

int hj_info(const uint8_t* data, long n, int* h, int* w, int* channels, char* err, int errcap) {
  Decoder dec(data, n);
  try {
    dec.parse(true);
    if (!dec.have_frame) throw Fail{"a JPEG without a frame header"};
  } catch (const Fail& f) {
    set_err(err, errcap, f.why);
    return -1;
  } catch (const std::exception& e) {  // e.g. no memory for a huge image's planes
    set_err(err, errcap, e.what());
    return -1;
  }
  *h = dec.height;
  *w = dec.width;
  *channels = dec.ncomp;
  return 0;
}

int hj_decode(const uint8_t* data, long n, uint8_t* out, int h, int w, int channels, char* err,
              int errcap) {
  Decoder dec(data, n);
  try {
    dec.parse(false);
    if (dec.height != h || dec.width != w || dec.ncomp != channels)
      throw Fail{"the JPEG's size is not the one asked for"};
    for (int c = 0; c < dec.ncomp; ++c)
      if (!dec.comp[c].seen) throw Fail{"a component has no scan"};
    dec.output(out);
  } catch (const Fail& f) {
    set_err(err, errcap, f.why);
    return -1;
  } catch (const std::exception& e) {  // e.g. no memory for a huge image's planes
    set_err(err, errcap, e.what());
    return -1;
  }
  return 0;
}

}  // extern "C"
