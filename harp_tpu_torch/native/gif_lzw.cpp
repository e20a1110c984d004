// GIF's variable-width LZW encoder (GIF89a, appendix F), with a plain C
// interface bound through ctypes (harp_tpu_torch/native/__init__.py,
// gif_lzw). The port writes its turntable GIFs itself (utils/viz.py:
// save_gif), as harp_tpu's Pillow does; this is the per-pixel loop of
// that writer.
//
//   hg_lzw(indices, n, out, cap) -> bytes written, or -1 if cap is short
//
// indices: n palette indices (0..255); the minimum code size is 8, so the
// clear code is 256 and the end code 257. out receives the packed code
// stream (least significant bit first), not yet cut into sub-blocks.
// Greedy LZW with a clear code when the table's 4096 codes are used up.
// Each code is written with the width a decoder reads it at: the bit
// length of (next free code - 1), at least 9.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEnd = 257, kFirst = 258, kMax = 4096;

struct Writer {
  uint8_t* out;
  long cap, pos = 0;
  uint32_t buf = 0;
  int bits = 0;
  bool full = false;
  void put(int code, int width) {
    buf |= static_cast<uint32_t>(code) << bits;
    bits += width;
    while (bits >= 8) {
      if (pos >= cap) { full = true; return; }
      out[pos++] = static_cast<uint8_t>(buf & 0xFF);
      buf >>= 8;
      bits -= 8;
    }
  }
  void flush() {
    if (bits > 0) {
      if (pos >= cap) { full = true; return; }
      out[pos++] = static_cast<uint8_t>(buf & 0xFF);
      buf = 0;
      bits = 0;
    }
  }
};

int width_of(int next) {
  int w = 9;
  while ((1 << w) <= next - 1 && w < 12) ++w;
  return w;
}

}  // namespace

extern "C" long hg_lzw(const uint8_t* idx, long n, uint8_t* out, long cap) {
  Writer wr{out, cap};
  // child[prefix * 256 + byte]: the code of (prefix's string + byte), 0 if none.
  std::vector<uint16_t> child(static_cast<size_t>(kMax) * 256, 0);
  std::vector<int> used;  // the child slots filled since the last clear
  used.reserve(kMax);
  int next = kFirst;
  wr.put(kClear, 9);
  if (n == 0) {
    wr.put(kEnd, 9);
    wr.flush();
    return wr.full ? -1 : wr.pos;
  }
  int prefix = idx[0];
  for (long i = 1; i < n; ++i) {
    const int c = idx[i];
    const int slot = prefix * 256 + c;
    if (child[slot]) {
      prefix = child[slot];
      continue;
    }
    wr.put(prefix, width_of(next));
    if (next < kMax) {
      child[slot] = static_cast<uint16_t>(next++);
      used.push_back(slot);
    } else {
      wr.put(kClear, width_of(next));
      for (int s : used) child[s] = 0;
      used.clear();
      next = kFirst;
    }
    prefix = c;
    if (wr.full) return -1;
  }
  wr.put(prefix, width_of(next));
  // The decoder adds one more entry when it reads the last code.
  wr.put(kEnd, width_of(next < kMax ? next + 1 : next));
  wr.flush();
  return wr.full ? -1 : wr.pos;
}
