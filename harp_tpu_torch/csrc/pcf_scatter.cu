// PCF shadow-map gradient scatter for Hopper (sm_90a): the CUDA counterpart
// of harp_tpu/render/pallas/pcf_grad_kernel.py (K3).
//
//   dpad[b, yc + di, xc + dj] += upd[b, i, 3 * (di + 1) + (dj + 1)]
//
// on the (B, Hl + 4, Hl + 4) twice-edge-padded light depth map. One thread
// per camera pixel, nine float atomicAdds into device memory (the map is
// 200 KB a frame and stays in L2). Taps whose update is exactly zero (the
// saturated sigmoid outside the shadow band) are skipped: adding 0 would not
// change the sum. Float atomics make the order of the additions, and so the
// last bits of the result, vary from run to run.
//
// Precondition (the caller clips): 1 <= yc, xc <= Hl + 2.

#include <cuda_runtime.h>

namespace {

__global__ void pcf_scatter_kernel(const int* __restrict__ yc,
                                   const int* __restrict__ xc,
                                   const float* __restrict__ upd, int N,
                                   int hp4, float* __restrict__ dpad) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t r = (size_t)b * N + i;
  const int y = yc[r], x = xc[r];
  const float* u = upd + r * 9;
  float* d = dpad + (size_t)b * hp4 * hp4;
  for (int di = -1; di <= 1; ++di) {
    for (int dj = -1; dj <= 1; ++dj) {
      const float v = u[3 * (di + 1) + (dj + 1)];
      if (v != 0.f) atomicAdd(d + (y + di) * hp4 + (x + dj), v);
    }
  }
}

}  // namespace

extern "C" int pcf_scatter(const int* yc, const int* xc, const float* upd,
                           int B, int N, int hl, float* dpad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp4 = hl + 4;
  cudaError_t err = cudaMemsetAsync(dpad, 0, sizeof(float) * (size_t)B * hp4 * hp4, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const dim3 grid((N + threads - 1) / threads, B);
  pcf_scatter_kernel<<<grid, threads, 0, s>>>(yc, xc, upd, N, hp4, dpad);
  return (int)cudaGetLastError();
}
