// Host JPEG frame decoder on libjpeg, with a plain C interface
// bound through ctypes (harp_tpu_torch/native/__init__.py).
//
// The port's counterpart of harp_tpu/native/frameloader.cpp: a whole
// sequence is decoded once, on a pool of threads, into one packed float32
// array (then copied to the device in one transfer), so the fit has no
// per-step loader. The decode matches harp_tpu's native path bit for bit
// against the same libjpeg build: the default DCT method and upsampling,
// JCS_GRAYSCALE for masks (the luma plane, not PIL's convert("L")
// weights), one size check per file against the first file, and
// v * (1.0f / 255.0f).
//
// (The host encoder is jpeg_codec.cpp, which needs no libjpeg.)
//
//   hf_probe(path, &h, &w)                                -> 0 or a status
//   hf_decode_batch(paths, n, h, w, gray, threads, out, status)
//       -> index of the first file that failed, or -1
//
// Status codes: 1 cannot open, 2 not a decodable JPEG, 3 wrong size.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

void no_message(j_common_ptr) {}

// Decode one file into out (h * w * channels float32). gray selects the
// luma plane. Returns 0 or a status code.
int decode_one(const char* path, int h, int w, int gray, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.output_message = no_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int c = cinfo.output_components;
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  // The row lives in libjpeg's own pool: an error's longjmp skips no
  // destructor, and jpeg_destroy_decompress frees it.
  JSAMPARRAY rows = (*cinfo.mem->alloc_sarray)(
      reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, w * c, 1);
  JSAMPROW rowp = rows[0];
  const float scale = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    const size_t y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out + y * static_cast<size_t>(w) * c;
    for (int x = 0; x < w * c; ++x) dst[x] = rowp[x] * scale;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

}  // namespace

extern "C" {

int hf_probe(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  err.mgr.output_message = no_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

long hf_decode_batch(const char* const* paths, int n, int h, int w, int gray,
                     int n_threads, float* out, int* status) {
  const size_t frame = static_cast<size_t>(h) * w * (gray ? 1 : 3);
  std::atomic<long> next(0);
  std::atomic<long> failed(-1);
  int workers = n_threads > 0 ? n_threads
                              : static_cast<int>(std::thread::hardware_concurrency());
  if (workers < 1) workers = 1;
  if (workers > n) workers = n;
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        const long i = next.fetch_add(1);
        if (i >= n || failed.load() >= 0) break;
        status[i] = decode_one(paths[i], h, w, gray, out + i * frame);
        if (status[i] != 0) {
          long none = -1;
          failed.compare_exchange_strong(none, i);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // extern "C"
