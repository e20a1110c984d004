// PCF shadow-map gradient scatter for Hopper (sm_90a): the CUDA counterpart
// of harp_tpu/render/pallas/pcf_grad_kernel.py (K3).
//
//   dpad[b, yc + di, xc + dj] += upd[b, i, 3 * (di + 1) + (dj + 1)]
//
// on the (B, Hl + 4, Hl + 4) twice-edge-padded light depth map, in an order
// fixed by the input. The scatter is split in two:
//   1. the segment sum (segment_sum.cu) adds each pixel's nine tap updates
//      into its tap centre: S[b, centre, tap], over the pixels sorted by
//      centre (the background pixels' centres pile up on a few clamped
//      texels; the segment sum cuts those runs into fixed chunks);
//   2. this kernel turns the centre sums into the map, as a gather: one
//      thread per map texel adds the nine centre sums whose tap lands on it,
//      in tap order.
// No float atomics, so dpad is the same bits from run to run.
//
// What bounds it: bytes. It reads the (B, Hp4^2, 9) centre sums once and
// writes the (B, Hp4^2) map; the nine reads of a thread are neighbours of
// its neighbours' and come from L1.

#include <cuda_runtime.h>

namespace {

__global__ void pcf_gather_taps_kernel(const float* __restrict__ csum, int hp4,
                                       float* __restrict__ dpad) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hp4 * hp4) return;
  const int Y = i / hp4, X = i % hp4;
  const float* s = csum + (size_t)b * hp4 * hp4 * 9;
  float acc = 0.f;
  for (int di = -1; di <= 1; ++di) {
    for (int dj = -1; dj <= 1; ++dj) {
      const int y = Y - di, x = X - dj;
      if (y >= 0 && y < hp4 && x >= 0 && x < hp4)
        acc += s[(size_t)(y * hp4 + x) * 9 + 3 * (di + 1) + (dj + 1)];
    }
  }
  dpad[(size_t)b * hp4 * hp4 + i] = acc;
}

}  // namespace

// csum (B, (hl + 4)^2, 9) f32 centre sums -> dpad (B, hl + 4, hl + 4) f32.
extern "C" int pcf_gather_taps(const float* csum, int B, int hl, float* dpad,
                               void* stream) {
  const int hp4 = hl + 4;
  const int threads = 256;
  const dim3 grid((hp4 * hp4 + threads - 1) / threads, B);
  pcf_gather_taps_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      csum, hp4, dpad);
  return (int)cudaGetLastError();
}
