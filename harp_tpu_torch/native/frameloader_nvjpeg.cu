// Card JPEG frame decoder and encoder on nvJPEG, with a plain C interface
// bound through ctypes (harp_tpu_torch/native/__init__.py).
//
// The card's machine has nvJPEG and no libjpeg, so on a CUDA device a
// sequence is decoded on the card: the host reads the files and checks
// each one's size (nvjpegGetImageInfo), then one batched decode
// (nvjpegDecodeBatched) writes every frame as uint8 straight into one
// device tensor, interleaved RGB (NVJPEG_OUTPUT_RGBI) or the luma plane
// for masks (NVJPEG_OUTPUT_Y, the plane libjpeg's JCS_GRAYSCALE gives).
// The caller scales by 1/255 on the device. nvJPEG's inverse DCT and
// chroma upsampling are not libjpeg's: its frames differ from the host
// decoder's by a few codes, inside harp_tpu's JPEG bounds.
//
// What bounds it: the Huffman decode of the bitstreams (on the host in
// nvJPEG's hybrid backend), not the card's memory: a 448^2 RGB frame is
// 0.6 MB of output.
//
// The encoder is the card's counterpart of Image.save(path, quality=q):
// baseline JPEG, 4:2:0 chroma for RGB, one grey component for masks.
//
//   hn_info(data, len, &components, &w, &h)                 -> nvjpegStatus_t
//   hn_decode_batch(data, lens, n, gray, out, h, w, stream)  -> nvjpegStatus_t
//   hn_encode_bound(h, w, channels, quality, &bytes)         -> nvjpegStatus_t
//   hn_encode(src, h, w, channels, quality, stream, out, capacity, &len)
//       -> nvjpegStatus_t, or -1 when the bitstream exceeds capacity
//
// All calls share one handle and one decoder / encoder state, made at
// first use and guarded by a mutex.

#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

std::mutex g_lock;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
nvjpegEncoderState_t g_enc_state = nullptr;
nvjpegEncoderParams_t g_enc_params = nullptr;

nvjpegStatus_t ensure_handle() {
  if (g_handle) return NVJPEG_STATUS_SUCCESS;
  nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return st;
  }
  return nvjpegJpegStateCreate(g_handle, &g_state);
}

nvjpegStatus_t ensure_encoder(cudaStream_t stream) {
  nvjpegStatus_t st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS || g_enc_state) return st;
  st = nvjpegEncoderStateCreate(g_handle, &g_enc_state, stream);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return nvjpegEncoderParamsCreate(g_handle, &g_enc_params, stream);
}

nvjpegStatus_t set_params(int channels, int quality, cudaStream_t stream) {
  nvjpegStatus_t st = nvjpegEncoderParamsSetQuality(g_enc_params, quality, stream);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = nvjpegEncoderParamsSetOptimizedHuffman(g_enc_params, 0, stream);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return nvjpegEncoderParamsSetSamplingFactors(
      g_enc_params, channels == 1 ? NVJPEG_CSS_GRAY : NVJPEG_CSS_420, stream);
}

}  // namespace

extern "C" {

int hn_info(const unsigned char* data, size_t len, int* components, int* w, int* h) {
  std::lock_guard<std::mutex> guard(g_lock);
  nvjpegStatus_t st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  st = nvjpegGetImageInfo(g_handle, data, len, components, &sub, widths, heights);
  *w = widths[0];
  *h = heights[0];
  return st;
}

int hn_decode_batch(const unsigned char* const* data, const size_t* lens, int n,
                    int gray, unsigned char* out, int h, int w, void* stream) {
  std::lock_guard<std::mutex> guard(g_lock);
  nvjpegStatus_t st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  const nvjpegOutputFormat_t fmt = gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI;
  st = nvjpegDecodeBatchedInitialize(g_handle, g_state, n, 1, fmt);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  const size_t pitch = static_cast<size_t>(w) * (gray ? 1 : 3);
  std::vector<nvjpegImage_t> dst(n);
  for (int i = 0; i < n; ++i) {
    std::memset(&dst[i], 0, sizeof(nvjpegImage_t));
    dst[i].channel[0] = out + static_cast<size_t>(i) * h * pitch;
    dst[i].pitch[0] = pitch;
  }
  return nvjpegDecodeBatched(g_handle, g_state, data, lens, dst.data(),
                             static_cast<cudaStream_t>(stream));
}

int hn_encode_bound(int h, int w, int channels, int quality, size_t* bytes) {
  std::lock_guard<std::mutex> guard(g_lock);
  nvjpegStatus_t st = ensure_encoder(nullptr);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = set_params(channels, quality, nullptr);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return nvjpegEncodeGetBufferSize(g_handle, g_enc_params, w, h, bytes);
}

int hn_encode(const unsigned char* src, int h, int w, int channels, int quality,
              void* stream, unsigned char* out, size_t capacity, size_t* len) {
  std::lock_guard<std::mutex> guard(g_lock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = ensure_encoder(s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = set_params(channels, quality, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = const_cast<unsigned char*>(src);
  img.pitch[0] = static_cast<size_t>(w) * channels;
  if (channels == 1) {
    st = nvjpegEncodeYUV(g_handle, g_enc_state, g_enc_params, &img, NVJPEG_CSS_GRAY,
                         w, h, s);
  } else {
    st = nvjpegEncodeImage(g_handle, g_enc_state, g_enc_params, &img,
                           NVJPEG_INPUT_RGBI, w, h, s);
  }
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  size_t need = 0;
  st = nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, nullptr, &need, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  if (need > capacity) return -1;
  st = nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, out, &need, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  if (cudaStreamSynchronize(s) != cudaSuccess) return NVJPEG_STATUS_EXECUTION_FAILED;
  *len = need;
  return NVJPEG_STATUS_SUCCESS;
}

}  // extern "C"
