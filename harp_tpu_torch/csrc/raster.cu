// Tile rasterizer kernels for Hopper (sm_90a): the CUDA counterparts of
// harp_tpu/render/pallas/raster_kernel.py.
//
//   raster_ids      (K1) _kernel: per active 16x16 tile, walks the tile's
//                   binned faces in ascending id and emits the hard id
//                   (nearest covering face), the first K soft ids within the
//                   blur radius and the coverage log-sum over all of them.
//                   NEED_SOFT=false is the depth-only mode of the light pass.
//   coverage_grad   (K2) _coverage_grad_kernel: the backward of the
//                   coverage log-sum, per (tile, face slot) the 9 screen
//                   coordinate gradients summed over the tile's pixels.
//
// Layout: one block per (active tile, frame), one thread per pixel. The
// block reads its face list straight from the sorted (tile, face) pair runs
// of the binning (s_face[start : start + count]) and stages the faces'
// vertices in shared memory CHUNK faces at a time, so any cap fits.
//
// Build with -fmad=false: the edge functions a*b - c*d must round exactly as
// the plain PyTorch version does, or boundary pixels flip ids.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;      // faces staged per shared-memory round (K1)
constexpr int GCHUNK = 64;      // faces per round in K2 (its reduction buffer)
constexpr int MAX_WARPS = 8;    // P = tile * tile <= 256 threads

struct Geo {
  bool valid;
  bool inside;
  float z;
};

__device__ __forceinline__ Geo face_geo(const float* v, float px, float py,
                                        float znear) {
  const float x0 = v[0], y0 = v[1], z0 = v[2];
  const float x1 = v[3], y1 = v[4], z1 = v[5];
  const float x2 = v[6], y2 = v[7], z2 = v[8];
  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const float w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py);
  const float w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py);
  const float w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py);
  const float denom = fabsf(area2) > 1e-10f ? area2
                      : (area2 >= 0.f ? 1e-10f : -1e-10f);
  const float b0 = w0 / denom, b1 = w1 / denom, b2 = w2 / denom;
  Geo g;
  g.valid = (fabsf(area2) > 1e-10f) && (z0 > znear) && (z1 > znear) &&
            (z2 > znear);
  g.inside = (b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f) && g.valid;
  g.z = b0 * z0 + b1 * z1 + b2 * z2;
  return g;
}

__device__ __forceinline__ float seg_d2(float px, float py, float ax, float ay,
                                        float bx, float by) {
  const float abx = bx - ax, aby = by - ay;
  const float apx = px - ax, apy = py - ay;
  const float dn = abx * abx + aby * aby + 1e-12f;
  float t = (apx * abx + apy * aby) / dn;
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float dx = apx - t * abx;
  const float dy = apy - t * aby;
  return dx * dx + dy * dy;
}

// Gradient of the squared point-segment distance D w.r.t. the endpoints,
// scaled by the upstream gD; jnp.clip's tie rule (half the gradient when
// the projection lands exactly on an endpoint) is reproduced.
__device__ __forceinline__ void seg_d2_grad(float px, float py, float ax,
                                            float ay, float bx, float by,
                                            float gD, float* ga, float* gb) {
  const float abx = bx - ax, aby = by - ay;
  const float apx = px - ax, apy = py - ay;
  const float dn = abx * abx + aby * aby + 1e-12f;
  const float v = (apx * abx + apy * aby) / dn;
  const float m = fmaxf(v, 0.f);
  const float dm = v > 0.f ? 1.f : (v == 0.f ? 0.5f : 0.f);
  const float t = fminf(m, 1.f);
  const float dt = m < 1.f ? 1.f : (m == 1.f ? 0.5f : 0.f);
  const float dx = apx - t * abx;
  const float dy = apy - t * aby;
  const float gdx = 2.f * dx * gD;
  const float gdy = 2.f * dy * gD;
  const float gv = -(gdx * abx + gdy * aby) * dt * dm;
  const float gnum = gv / dn;
  const float gdn = -gv * v / dn;
  const float g_apx = gdx + gnum * abx;
  const float g_apy = gdy + gnum * aby;
  const float g_abx = -gdx * t + gnum * apx + 2.f * abx * gdn;
  const float g_aby = -gdy * t + gnum * apy + 2.f * aby * gdn;
  ga[0] += -g_apx - g_abx;
  ga[1] += -g_apy - g_aby;
  gb[0] += g_abx;
  gb[1] += g_aby;
}

// jnp.minimum's tie rule: the gradient splits evenly between equal operands.
__device__ __forceinline__ float min_w(float a, float b) {
  return a < b ? 1.f : (a == b ? 0.5f : 0.f);
}

// Stage face ids and vertex rows [c0, c0 + nc) of this tile's list.
__device__ __forceinline__ void stage_faces(const float* fv9, const int* run,
                                            int c0, int nc, size_t frame_off,
                                            int* sid, float* sv) {
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += blockDim.x) sid[i] = run[c0 + i];
  __syncthreads();
  for (int i = threadIdx.x; i < nc * 9; i += blockDim.x) {
    sv[i] = fv9[frame_off + (size_t)sid[i / 9] * 9 + (i % 9)];
  }
  __syncthreads();
}

template <bool NEED_SOFT>
__global__ void raster_ids_kernel(
    const float* __restrict__ fv9, const int* __restrict__ s_face,
    const int* __restrict__ start_a, const int* __restrict__ count_a,
    const int* __restrict__ act_idx, int F, int n, int A, int nt, int tile,
    int K, float blur_px2, float znear, float ndc2, float inv_sigma,
    int* __restrict__ hard_out, int* __restrict__ soft_out,
    float* __restrict__ ssum_out) {
  __shared__ float sv[CHUNK * 9];
  __shared__ int sid[CHUNK];
  const int a = blockIdx.x, b = blockIdx.y, p = threadIdx.x;
  const int P = tile * tile;
  const size_t ba = (size_t)b * A + a;
  const int t = act_idx[ba];
  const float px = (float)((t % nt) * tile + p % tile) + 0.5f;
  const float py = (float)((t / nt) * tile + p / tile) + 0.5f;
  const int count = count_a[ba];
  const int* run = s_face + (size_t)b * n + start_a[ba];
  const size_t frame_off = (size_t)b * F * 9;

  float zmin = INFINITY;
  int hard = -1;
  int hits = 0;
  float ssum = 0.f;
  int* soft = soft_out + (ba * P + p) * K;
  if (NEED_SOFT) {
    for (int k = 0; k < K; ++k) soft[k] = -1;
  }
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int nc = min(CHUNK, count - c0);
    stage_faces(fv9, run, c0, nc, frame_off, sid, sv);
    for (int j = 0; j < nc; ++j) {
      const float* v = sv + j * 9;
      const Geo g = face_geo(v, px, py, znear);
      if (g.inside && g.z < zmin) {  // strict: ties keep the lower id
        zmin = g.z;
        hard = sid[j];
      }
      if (NEED_SOFT && g.valid) {
        const float d2 = fminf(fminf(seg_d2(px, py, v[0], v[1], v[3], v[4]),
                                     seg_d2(px, py, v[3], v[4], v[6], v[7])),
                               seg_d2(px, py, v[6], v[7], v[0], v[1]));
        const float s = g.inside ? -d2 : d2;
        if (s <= blur_px2) {
          if (hits < K) soft[hits] = sid[j];
          ++hits;
          // log(1 - p) = -softplus(x), softplus as jnp.logaddexp(x, 0).
          const float x = -(s * ndc2) * inv_sigma;
          ssum -= fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        }
      }
    }
  }
  hard_out[ba * P + p] = hard;
  if (NEED_SOFT) ssum_out[ba * P + p] = ssum;
}

__global__ void coverage_grad_kernel(
    const float* __restrict__ fv9, const int* __restrict__ s_face,
    const int* __restrict__ start_a, const int* __restrict__ count_a,
    const int* __restrict__ act_idx, const float* __restrict__ g_in, int F,
    int n, int A, int nt, int tile, int cap, float blur_px2, float znear,
    float ndc2, float inv_sigma, float* __restrict__ out) {
  __shared__ float sv[GCHUNK * 9];
  __shared__ int sid[GCHUNK];
  __shared__ float red[MAX_WARPS][GCHUNK][6];
  const int a = blockIdx.x, b = blockIdx.y, p = threadIdx.x;
  const int P = tile * tile;
  const int warp = p / 32, lane = p % 32, nwarps = P / 32;
  const size_t ba = (size_t)b * A + a;
  const int t = act_idx[ba];
  const float px = (float)((t % nt) * tile + p % tile) + 0.5f;
  const float py = (float)((t / nt) * tile + p / tile) + 0.5f;
  const int count = count_a[ba];
  const int* run = s_face + (size_t)b * n + start_a[ba];
  const size_t frame_off = (size_t)b * F * 9;
  const float gp = g_in[ba * P + p];
  float* out_tile = out + ba * (size_t)cap * 9;

  for (int c0 = 0; c0 < count; c0 += GCHUNK) {
    const int nc = min(GCHUNK, count - c0);
    stage_faces(fv9, run, c0, nc, frame_off, sid, sv);
    for (int j = 0; j < nc; ++j) {
      const float* v = sv + j * 9;
      float gr[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // (x, y) of v0, v1, v2
      const Geo g = face_geo(v, px, py, znear);
      bool hit = false;
      if (g.valid && gp != 0.f) {
        const float e01 = seg_d2(px, py, v[0], v[1], v[3], v[4]);
        const float e12 = seg_d2(px, py, v[3], v[4], v[6], v[7]);
        const float e20 = seg_d2(px, py, v[6], v[7], v[0], v[1]);
        const float m1 = fminf(e01, e12);
        const float d2 = fminf(m1, e20);
        const float s = g.inside ? -d2 : d2;
        hit = s <= blur_px2;
        if (hit) {
          // d(-softplus(x))/ds with x = -(s * ndc2) * inv_sigma.
          const float x = -(s * ndc2) * inv_sigma;
          const float sig = 1.f / (1.f + expf(-x));
          const float gd2 = gp * sig * ndc2 * inv_sigma * (g.inside ? -1.f : 1.f);
          const float wm = min_w(m1, e20);
          const float w01 = min_w(e01, e12) * wm;
          const float w12 = min_w(e12, e01) * wm;
          const float w20 = min_w(e20, m1);
          if (w01 > 0.f) seg_d2_grad(px, py, v[0], v[1], v[3], v[4], gd2 * w01, gr + 0, gr + 2);
          if (w12 > 0.f) seg_d2_grad(px, py, v[3], v[4], v[6], v[7], gd2 * w12, gr + 2, gr + 4);
          if (w20 > 0.f) seg_d2_grad(px, py, v[6], v[7], v[0], v[1], gd2 * w20, gr + 4, gr + 0);
        }
      }
      // Warp sum in a fixed order, then one partial per warp in shared
      // memory: the per-slot result does not depend on scheduling.
      if (__any_sync(0xffffffffu, hit)) {
        for (int c = 0; c < 6; ++c) {
          float x = gr[c];
          for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
          gr[c] = x;
        }
      }
      if (lane == 0) {
        for (int c = 0; c < 6; ++c) red[warp][j][c] = gr[c];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * 9; i += blockDim.x) {
      const int j = i / 9, c = i % 9;
      float acc = 0.f;
      if (c % 3 != 2) {  // z lanes get exactly zero gradient
        const int r = (c / 3) * 2 + (c % 3);
        for (int w = 0; w < nwarps; ++w) acc += red[w][j][r];
      }
      out_tile[(size_t)(c0 + j) * 9 + c] = acc;
    }
  }
}

}  // namespace

extern "C" int raster_ids(const float* fv9, const int* s_face,
                          const int* start_a, const int* count_a,
                          const int* act_idx, int B, int F, int n, int A,
                          int nt, int tile, int K, float blur_px2, float znear,
                          float ndc2, float inv_sigma, int need_soft,
                          int* hard, int* soft, float* ssum, void* stream) {
  const dim3 grid(A, B);
  const dim3 block(tile * tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_soft) {
    raster_ids_kernel<true><<<grid, block, 0, s>>>(
        fv9, s_face, start_a, count_a, act_idx, F, n, A, nt, tile, K,
        blur_px2, znear, ndc2, inv_sigma, hard, soft, ssum);
  } else {
    raster_ids_kernel<false><<<grid, block, 0, s>>>(
        fv9, s_face, start_a, count_a, act_idx, F, n, A, nt, tile, K,
        blur_px2, znear, ndc2, inv_sigma, hard, soft, ssum);
  }
  return (int)cudaGetLastError();
}

extern "C" int coverage_grad(const float* fv9, const int* s_face,
                             const int* start_a, const int* count_a,
                             const int* act_idx, const float* g, int B, int F,
                             int n, int A, int nt, int tile, int cap,
                             float blur_px2, float znear, float ndc2,
                             float inv_sigma, float* out, void* stream) {
  const dim3 grid(A, B);
  const dim3 block(tile * tile);
  coverage_grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      fv9, s_face, start_a, count_a, act_idx, g, F, n, A, nt, tile, cap,
      blur_px2, znear, ndc2, inv_sigma, out);
  return (int)cudaGetLastError();
}
