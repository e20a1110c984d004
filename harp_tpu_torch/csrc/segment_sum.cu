// Fixed-order segmented row sum for Hopper (sm_90a).
//
//   out[r, :] = sum of values[j, :] over the entries j with key[j] == r
//
// It is the backward of every row gather on the fit step's path (texture
// sampling, the packed-attribute and face-row gathers, the texture
// regularisers), the forward of the vertex-normal accumulation and the core
// of the PCF tap scatter (K3). harp_tpu has no Pallas kernel for it: there
// XLA transposes the gathers into scatter-adds.
//
// The caller supplies the entries in key order: skey (the keys, sorted) and
// perm (the entry each sorted position came from, from a stable sort). The
// sum of a row is then taken in an order fixed by the input alone, so the
// result is the same bits from run to run. There are no float atomics.
//
// Pass 1 cuts the sorted entries into chunks of E, one block a chunk, one
// thread an entry. Per channel the block runs a segmented inclusive scan: warp
// shuffles by lane position, then the warp totals in warp order. A segment
// wholly inside the chunk is written straight to out. A segment that crosses
// a chunk edge leaves the chunk's partial in head (the chunk's first segment)
// or tail (its last). Pass 2 gives each crossing segment to the chunk where
// it starts, which adds the partials in chunk order. No run is walked entry
// by entry: a run of 10^5 entries (the background pixels of a frame all
// sample one clamped texel) costs each block one chunk's work and pass 2 one
// add per chunk.
//
// What bounds it: bytes. It reads M * (C + 2) * 4 bytes (values, skey, perm)
// and writes R * C * 4; the arithmetic is a few adds per value.

#include <cuda_runtime.h>

namespace {

constexpr int E = 256;  // entries per chunk: one block of E threads
constexpr int WARPS = E / 32;

__global__ void __launch_bounds__(E)
chunk_sums_kernel(const int* __restrict__ skey, const int* __restrict__ perm,
                  const float* __restrict__ values, int M, int C,
                  float* __restrict__ out, float* __restrict__ head,
                  float* __restrict__ tail) {
  __shared__ float wsum[2][WARPS];
  __shared__ int wflag[2][WARPS];
  __shared__ float carry[2][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.x * E;
  const int n = min(E, M - c0);
  const int j = c0 + t;
  const bool live = t < n;
  const int key = live ? skey[j] : -1;
  const int key0 = skey[c0];
  const int keyl = skey[c0 + n - 1];
  const bool seg_head = live && (t == 0 || skey[j - 1] != key);
  const bool seg_end = live && (t == n - 1 || skey[j + 1] != key);
  const bool cross_before = blockIdx.x > 0 && skey[c0 - 1] == key0;
  const bool cross_after = c0 + n < M && skey[c0 + n] == keyl;
  const bool crossing = (key == key0 && cross_before) || (key == keyl && cross_after);
  const size_t row = live ? (size_t)perm[j] * C : 0;
  for (int c = 0; c < C; ++c) {
    const int p = c & 1;  // double-buffered shared state: one barrier less
    float v = live ? values[row + c] : 0.f;
    int f = seg_head;
    for (int d = 1; d < 32; d <<= 1) {
      const float vo = __shfl_up_sync(0xffffffffu, v, d);
      const int fo = __shfl_up_sync(0xffffffffu, f, d);
      if (lane >= d) {
        if (!f) v = vo + v;
        f |= fo;
      }
    }
    if (lane == 31) {
      wsum[p][warp] = v;
      wflag[p][warp] = f;
    }
    __syncthreads();
    if (t == 0) {
      float acc = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        carry[p][w] = acc;
        acc = wflag[p][w] ? wsum[p][w] : acc + wsum[p][w];
      }
    }
    __syncthreads();
    if (!f) v = carry[p][warp] + v;
    if (seg_end) {
      if (!crossing) {
        out[(size_t)key * C + c] = v;
      } else {
        if (key == key0) head[(size_t)blockIdx.x * C + c] = v;
        if (key == keyl) tail[(size_t)blockIdx.x * C + c] = v;
      }
    }
  }
}

// One thread per (chunk edge, channel). The segment across the edge after
// chunk c is summed by the thread of the chunk it starts in: its tail
// partial, then the head partial of every later chunk it covers, in order.
__global__ void cross_sums_kernel(const int* __restrict__ skey, int M, int C,
                                  int nchunks, const float* __restrict__ head,
                                  const float* __restrict__ tail,
                                  float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)(nchunks - 1) * C) return;
  const int c = (int)(i / C), ch = (int)(i % C);
  const int edge = (c + 1) * E;
  const int key = skey[edge - 1];
  if (skey[edge] != key) return;                // no segment crosses
  if (c > 0 && skey[c * E - 1] == key) return;  // it starts in an earlier chunk
  int lo = edge, hi = M;  // skey[lo] == key; skey[hi] > key or hi == M
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (skey[mid] == key) lo = mid; else hi = mid;
  }
  const int last = lo / E;
  float acc = tail[(size_t)c * C + ch];
  for (int k = c + 1; k <= last; ++k) acc = acc + head[(size_t)k * C + ch];
  out[(size_t)key * C + ch] = acc;
}

}  // namespace

extern "C" int segment_sum_chunk() { return E; }

// skey, perm (M,) int32; values (M, C) f32; out (R, C) f32; head, tail
// (ceil(M / E), C) f32 scratch. Keys must lie in [0, R).
extern "C" int segment_sum(const int* skey, const int* perm, const float* values,
                           int M, int C, int R, float* out, float* head,
                           float* tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)R * C, s);
  if (err != cudaSuccess || M == 0) return (int)err;
  const int nchunks = (M + E - 1) / E;
  chunk_sums_kernel<<<nchunks, E, 0, s>>>(skey, perm, values, M, C, out, head, tail);
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  const long n = (long)(nchunks - 1) * C;
  const int threads = 256;
  cross_sums_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      skey, M, C, nchunks, head, tail, out);
  return (int)cudaGetLastError();
}
