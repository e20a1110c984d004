// Tile rasterizer kernels for Hopper (sm_90a): the CUDA counterparts of
// harp_tpu/render/pallas/raster_kernel.py.
//
//   raster_ids      (K1) _kernel: per active tile, walks the tile's binned
//                   faces in ascending id and emits the hard id (nearest
//                   covering face), the first K soft ids within the blur
//                   radius and the coverage log-sum over all of them.
//                   NEED_SOFT=false is the depth-only mode of the light pass.
//   coverage_grad   (K2) _coverage_grad_kernel: the backward of the
//                   coverage log-sum, per (tile, face slot) the 9 screen
//                   coordinate gradients summed over the tile's pixels.
//
// Layout: one block per (active tile, frame), one thread per pixel, each
// warp an 8x4 pixel rectangle of the tile (the pixel's outputs stay at
// p = row * tile + col). The block reads its face list straight from the
// sorted (tile, face) pair runs of the binning (s_face[start : start +
// count]) and walks it CHUNK faces at a time, so any cap fits.
//
// What bounds them: FP32 operations on the CUDA cores. Bytes are few (a
// frame's face rows and lists, and the ids), but every (pixel, binned face)
// pair costs edge functions, and in soft mode three clipped point-segment
// distances. The design cuts the operations, not their rate:
//   1. Warp-uniform culling. Each staged face carries its bounding box,
//      padded by the binning's pad sqrt(blur_px2) + 1e-3 plus a 1 px
//      margin. A warp tests 32 faces' boxes against its pixel rectangle at
//      once (one ballot) and walks only the faces that touch it, in list
//      order. A culled pair is neither inside nor within blur of its face,
//      so hard ids, soft ids and their order, the log-sum's terms and K2's
//      nonzero partials are the same; the cull only drops exact zeros.
//      Invalid faces (degenerate, or behind znear) get an empty box: they
//      never hit. (At 448^2 the blur radius is 0.21 px and faces are a few
//      pixels wide: most binned faces miss most of a tile's rectangles.)
//   2. Per-face setup once per (tile, face). area2, denom, the sign test's
//      threshold, each edge's (abx, aby, dn) and the box are computed by
//      the staging threads into shared memory, with the expressions the
//      per-pair code used, so they are the same bits.
//   3. Division-free coverage tests (quot_nonneg). b_i >= 0 becomes a sign
//      test on w_i; the three divisions and the depth run only where the
//      pixel is inside, and only in K1. seg_d2 keeps its division: its t
//      decides d2, and d2 decides a hit.
//   4. K1 keeps the soft ids in registers and writes them once, with
//      vector stores, after the walk, where K <= 8 (the default). A larger
//      K (50 in the reference's exact configuration) writes each hit's id
//      straight to global memory: K registers a thread would cut residency.
//   5. While a chunk is evaluated, cp.async brings the next chunk's face
//      rows into the other half of a double buffer (rows are gathered by
//      id, so TMA's tiled copies do not fit). The light pass's cap of 1344
//      faces is up to 11 chunks.
// Tensor cores are not used: the per-pair work is branchy scalar FP32
// whose rounding decides integer ids, with no matrix product in it.
//
// Build with -fmad=false: the edge functions a*b - c*d must round exactly as
// the plain PyTorch version does, or boundary pixels flip ids.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;      // faces staged per round (K1)
constexpr int GCHUNK = 64;      // faces per round in K2 (its partial buffer)
constexpr int MAX_WARPS = 8;    // P = tile * tile <= 256 threads
constexpr int RECT_W = 8;       // a warp's pixel rectangle, RECT_W x RECT_H
constexpr int RECT_H = 4;
constexpr unsigned FULL = 0xffffffffu;

// One staged face: its vertices, the sign test's constants, the depth
// denominator and the three edges v0v1, v1v2, v2v0 as (abx, aby, dn).
struct alignas(16) FaceSetup {
  float4 xy;  // x0, y0, x1, y1
  float4 xs;  // x2, y2, sgn, neg_t
  float4 zd;  // z0, z1, z2, denom
  float4 e0;  // abx01, aby01, dn01, abx12
  float4 e1;  // aby12, dn12, abx20, aby20
  float4 e2;  // dn20, -, -, -
};

template <int C>
struct Staging {
  float raw[2][C * 9];  // face rows, double-buffered (cp.async)
  int rid[2][C];        // face ids of the rows
  FaceSetup face[C];
  float4 box[C];        // padded bounding box: xmin, xmax, ymin, ymax
};

// w / denom >= 0 without the division, exactly as IEEE division decides it
// (-prec-div, round to nearest even). With sgn = +-1, the sign of denom,
// w / denom = (w * sgn) / |denom| (negation is exact, and division rounds
// symmetrically). For w * sgn >= 0 the quotient is >= 0 (+0 included). For
// w * sgn < 0 it is >= 0 only when it rounds to -0, i.e. when |w| / |denom|
// <= 2^-150 (a tie at 2^-150 goes to the even 0), i.e. when |w| <=
// RD(|denom| * 2^-150) = t, as |w| is a float. So the test is
// w * sgn >= -t. NaN w fails both. Exact for every float32 w and every
// finite nonzero denom; denom is never 0 (its clamp to +-1e-10) and is
// finite while the face's cross products stay below FLT_MAX (coordinates
// below ~1e19 px). At 448^2, t < 2^-108, far below any nonzero w there.
__device__ __forceinline__ bool quot_nonneg(float w, float sgn, float neg_t) {
  return w * sgn >= neg_t;
}

// Squared distance from the pixel to the segment a -> a + ab (dn = |ab|^2 +
// 1e-12), in the plain version's operation order.
__device__ __forceinline__ float seg_d2(float px, float py, float ax, float ay,
                                        float abx, float aby, float dn) {
  const float apx = px - ax, apy = py - ay;
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
                                            float ay, float abx, float aby,
                                            float dn, float gD, float* ga,
                                            float* gb) {
  const float apx = px - ax, apy = py - ay;
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the ids and rows of list slots [c0, c0 + nc) into one half
// of the double buffer, as one cp.async group.
__device__ __forceinline__ void prefetch_rows(const float* fvb, const int* run,
                                              int c0, int nc, float* raw,
                                              int* rid) {
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const int id = run[c0 + i];
    rid[i] = id;
    const float* src = fvb + (size_t)id * 9;
    for (int c = 0; c < 9; ++c) cp_async4(raw + i * 9 + c, src + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Per-face setup of a staged row, in the per-pair code's expressions.
template <bool EDGES>
__device__ __forceinline__ void setup_face(const float* v, float znear,
                                           float pad, FaceSetup* f,
                                           float4* box) {
  const float x0 = v[0], y0 = v[1], z0 = v[2];
  const float x1 = v[3], y1 = v[4], z1 = v[5];
  const float x2 = v[6], y2 = v[7], z2 = v[8];
  const float area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
  const float denom = fabsf(area2) > 1e-10f ? area2
                      : (area2 >= 0.f ? 1e-10f : -1e-10f);
  const bool valid = (fabsf(area2) > 1e-10f) && (z0 > znear) && (z1 > znear) &&
                     (z2 > znear);
  // RD(|denom| * 2^-150): the product is exact in double.
  const float t = __double2float_rd((double)fabsf(denom) * 0x1p-150);
  f->xy = make_float4(x0, y0, x1, y1);
  f->xs = make_float4(x2, y2, denom > 0.f ? 1.f : -1.f, -t);
  f->zd = make_float4(z0, z1, z2, denom);
  if (EDGES) {
    const float abx01 = x1 - x0, aby01 = y1 - y0;
    const float abx12 = x2 - x1, aby12 = y2 - y1;
    const float abx20 = x0 - x2, aby20 = y0 - y2;
    f->e0 = make_float4(abx01, aby01, abx01 * abx01 + aby01 * aby01 + 1e-12f, abx12);
    f->e1 = make_float4(aby12, abx12 * abx12 + aby12 * aby12 + 1e-12f, abx20, aby20);
    f->e2 = make_float4(abx20 * abx20 + aby20 * aby20 + 1e-12f, 0.f, 0.f, 0.f);
  }
  *box = valid ? make_float4(fminf(fminf(x0, x1), x2) - pad,
                             fmaxf(fmaxf(x0, x1), x2) + pad,
                             fminf(fminf(y0, y1), y2) - pad,
                             fmaxf(fmaxf(y0, y1), y2) + pad)
               : make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
}

// Where a thread's pixel and its warp's rectangle lie.
struct PixelMap {
  int p;                   // row * tile + col inside the tile
  float px, py;            // pixel centre
  float rx0, rx1, ry0, ry1;  // the warp's pixel centres span [rx0, rx1] x [ry0, ry1]
};

__device__ __forceinline__ PixelMap pixel_map(int t, int nt, int tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rpr = tile / RECT_W;  // rectangles per tile row
  const int c0 = (warp % rpr) * RECT_W, r0 = (warp / rpr) * RECT_H;
  const int col = c0 + lane % RECT_W, row = r0 + lane / RECT_W;
  const int ox = (t % nt) * tile, oy = (t / nt) * tile;
  PixelMap m;
  m.p = row * tile + col;
  m.px = (float)(ox + col) + 0.5f;
  m.py = (float)(oy + row) + 0.5f;
  m.rx0 = (float)(ox + c0) + 0.5f;
  m.rx1 = (float)(ox + c0 + RECT_W - 1) + 0.5f;
  m.ry0 = (float)(oy + r0) + 0.5f;
  m.ry1 = (float)(oy + r0 + RECT_H - 1) + 0.5f;
  return m;
}

// Bit j of the result: staged face g0 + j's box touches the warp's rectangle.
// Where rec is not null (asked for by a check, never on the main path), lane
// 0 also writes the ballot to rec[(s0 / 32) * warps + warp], s0 being the
// list slot of face g0.
__device__ __forceinline__ unsigned warp_keep(const float4* box, int g0, int nc,
                                              const PixelMap& m, unsigned* rec,
                                              int s0) {
  const int j = g0 + threadIdx.x % 32;
  bool keep = false;
  if (j < nc) {
    const float4 b = box[j];
    keep = b.x <= m.rx1 && b.y >= m.rx0 && b.z <= m.ry1 && b.w >= m.ry0;
  }
  const unsigned ballot = __ballot_sync(FULL, keep);
  if (rec != nullptr && threadIdx.x % 32 == 0) {
    rec[(s0 / 32) * (blockDim.x / 32) + threadIdx.x / 32] = ballot;
  }
  return ballot;
}

// Where a block's ballots go: keep_out is (B, A, kw, warps), or null.
__device__ __forceinline__ unsigned* ballot_rows(unsigned* keep_out, size_t ba,
                                                 int kw) {
  return keep_out == nullptr ? nullptr
                             : keep_out + ba * (size_t)kw * (blockDim.x / 32);
}

// Walks the tile's list chunk by chunk: prefetch the next chunk, set up the
// current one, then body(buf, nc, c0) evaluates it. Every thread of the
// block calls this with the same count.
template <int C, bool EDGES, typename Body>
__device__ __forceinline__ void walk_faces(Staging<C>& sm, const float* fvb,
                                           const int* run, int count,
                                           float znear, float pad, Body body) {
  const int nchunks = (count + C - 1) / C;
  if (nchunks > 0) prefetch_rows(fvb, run, 0, min(C, count), sm.raw[0], sm.rid[0]);
  for (int k = 0; k < nchunks; ++k) {
    const int buf = k & 1, c0 = k * C, nc = min(C, count - c0);
    if (k + 1 < nchunks) {
      prefetch_rows(fvb, run, c0 + C, min(C, count - c0 - C), sm.raw[buf ^ 1],
                    sm.rid[buf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      setup_face<EDGES>(sm.raw[buf] + i * 9, znear, pad, &sm.face[i], &sm.box[i]);
    }
    __syncthreads();
    body(buf, nc, c0);
    __syncthreads();  // the setup and this half of the buffer are free again
  }
}

// KMAX > 0: up to KMAX soft ids in registers (K <= KMAX). KMAX == 0: any K,
// each hit's id written straight to soft_out.
template <bool NEED_SOFT, int KMAX>
__global__ void __launch_bounds__(256) raster_ids_kernel(
    const float* __restrict__ fv9, const int* __restrict__ s_face,
    const int* __restrict__ start_a, const int* __restrict__ count_a,
    const int* __restrict__ act_idx, int F, int n, int A, int nt, int tile,
    int K, float blur_px2, float znear, float ndc2, float inv_sigma, float pad,
    int* __restrict__ hard_out, int* __restrict__ soft_out,
    float* __restrict__ ssum_out, int kw, unsigned* __restrict__ keep_out) {
  __shared__ Staging<CHUNK> sm;
  const int a = blockIdx.x, b = blockIdx.y;
  const size_t ba = (size_t)b * A + a;
  const PixelMap m = pixel_map(act_idx[ba], nt, tile);
  const float px = m.px, py = m.py;
  const size_t o = ba * (size_t)(tile * tile) + m.p;
  unsigned* rec = ballot_rows(keep_out, ba, kw);

  float zmin = INFINITY;
  int hard = -1;
  int hits = 0;
  float ssum = 0.f;
  int soft[KMAX > 0 ? KMAX : 1];
  int* soft_dst = NEED_SOFT ? soft_out + o * K : nullptr;
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int q = 0; q < KMAX; ++q) soft[q] = -1;
  } else if constexpr (NEED_SOFT) {
    for (int q = 0; q < K; ++q) soft_dst[q] = -1;
  }

  walk_faces<CHUNK, NEED_SOFT>(
      sm, fv9 + (size_t)b * F * 9, s_face + (size_t)b * n + start_a[ba],
      count_a[ba], znear, pad, [&](int buf, int nc, int c0) {
        for (int g0 = 0; g0 < nc; g0 += 32) {
          for (unsigned keep = warp_keep(sm.box, g0, nc, m, rec, c0 + g0); keep;
               keep &= keep - 1) {
            const int j = g0 + __ffs(keep) - 1;
            const FaceSetup& f = sm.face[j];
            const float4 xy = f.xy, xs = f.xs;
            const float x0 = xy.x, y0 = xy.y, x1 = xy.z, y1 = xy.w;
            const float x2 = xs.x, y2 = xs.y;
            const float w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py);
            const float w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py);
            const float w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py);
            const bool inside = quot_nonneg(w0, xs.z, xs.w) &&
                                quot_nonneg(w1, xs.z, xs.w) &&
                                quot_nonneg(w2, xs.z, xs.w);
            const int id = sm.rid[buf][j];
            if (inside) {
              const float4 zd = f.zd;
              const float z = (w0 / zd.w) * zd.x + (w1 / zd.w) * zd.y +
                              (w2 / zd.w) * zd.z;
              if (z < zmin) {  // strict: ties keep the lower id
                zmin = z;
                hard = id;
              }
            }
            if (NEED_SOFT) {
              const float4 e0 = f.e0, e1 = f.e1, e2 = f.e2;
              const float d2 = fminf(fminf(seg_d2(px, py, x0, y0, e0.x, e0.y, e0.z),
                                           seg_d2(px, py, x1, y1, e0.w, e1.x, e1.y)),
                                     seg_d2(px, py, x2, y2, e1.z, e1.w, e2.x));
              const float s = inside ? -d2 : d2;
              if (s <= blur_px2) {
                if constexpr (KMAX > 0) {
#pragma unroll
                  for (int q = 0; q < KMAX; ++q) {  // registers, not local memory
                    if (q == hits) soft[q] = id;
                  }
                } else if (hits < K) {
                  soft_dst[hits] = id;
                }
                ++hits;
                // log(1 - p) = -softplus(x), softplus as jnp.logaddexp(x, 0).
                const float x = -(s * ndc2) * inv_sigma;
                ssum -= fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
              }
            }
          }
        }
      });

  hard_out[o] = hard;
  if constexpr (NEED_SOFT) ssum_out[o] = ssum;
  if constexpr (NEED_SOFT && KMAX > 0) {
    if (K == KMAX) {
#pragma unroll
      for (int q = 0; q < KMAX; q += 4) {
        *reinterpret_cast<int4*>(soft_dst + q) =
            make_int4(soft[q], soft[q + 1], soft[q + 2], soft[q + 3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q < K) soft_dst[q] = soft[q];
      }
    }
  }
}

__global__ void __launch_bounds__(256) coverage_grad_kernel(
    const float* __restrict__ fv9, const int* __restrict__ s_face,
    const int* __restrict__ start_a, const int* __restrict__ count_a,
    const int* __restrict__ act_idx, const float* __restrict__ g_in, int F,
    int n, int A, int nt, int tile, int cap, float blur_px2, float znear,
    float ndc2, float inv_sigma, float pad, float* __restrict__ out,
    unsigned* __restrict__ keep_out) {
  __shared__ Staging<GCHUNK> sm;
  __shared__ float red[MAX_WARPS][GCHUNK][6];
  __shared__ unsigned long long wrote[MAX_WARPS];  // slots with a partial
  const int a = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const size_t ba = (size_t)b * A + a;
  const PixelMap m = pixel_map(act_idx[ba], nt, tile);
  const float px = m.px, py = m.py;
  const float gp = g_in[ba * (size_t)(tile * tile) + m.p];
  float* out_tile = out + ba * (size_t)cap * 9;
  unsigned* rec = ballot_rows(keep_out, ba, (cap + 31) / 32);

  walk_faces<GCHUNK, true>(
      sm, fv9 + (size_t)b * F * 9, s_face + (size_t)b * n + start_a[ba],
      count_a[ba], znear, pad, [&](int, int nc, int c0) {
        unsigned long long mine = 0;
        for (int g0 = 0; g0 < nc; g0 += 32) {
          for (unsigned keep = warp_keep(sm.box, g0, nc, m, rec, c0 + g0); keep;
               keep &= keep - 1) {
            const int j = g0 + __ffs(keep) - 1;
            const FaceSetup& f = sm.face[j];
            float gr[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // (x, y) of v0, v1, v2
            bool hit = false;
            if (gp != 0.f) {
              const float4 xy = f.xy, xs = f.xs;
              const float4 e0 = f.e0, e1 = f.e1, e2 = f.e2;
              const float x0 = xy.x, y0 = xy.y, x1 = xy.z, y1 = xy.w;
              const float x2 = xs.x, y2 = xs.y;
              const float w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py);
              const float w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py);
              const float w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py);
              const bool inside = quot_nonneg(w0, xs.z, xs.w) &&
                                  quot_nonneg(w1, xs.z, xs.w) &&
                                  quot_nonneg(w2, xs.z, xs.w);
              const float e01 = seg_d2(px, py, x0, y0, e0.x, e0.y, e0.z);
              const float e12 = seg_d2(px, py, x1, y1, e0.w, e1.x, e1.y);
              const float e20 = seg_d2(px, py, x2, y2, e1.z, e1.w, e2.x);
              const float m1 = fminf(e01, e12);
              const float d2 = fminf(m1, e20);
              const float s = inside ? -d2 : d2;
              hit = s <= blur_px2;
              if (hit) {
                // d(-softplus(x))/ds with x = -(s * ndc2) * inv_sigma.
                const float x = -(s * ndc2) * inv_sigma;
                const float sig = 1.f / (1.f + expf(-x));
                const float gd2 = gp * sig * ndc2 * inv_sigma * (inside ? -1.f : 1.f);
                const float wm = min_w(m1, e20);
                const float w01 = min_w(e01, e12) * wm;
                const float w12 = min_w(e12, e01) * wm;
                const float w20 = min_w(e20, m1);
                if (w01 > 0.f) seg_d2_grad(px, py, x0, y0, e0.x, e0.y, e0.z, gd2 * w01, gr + 0, gr + 2);
                if (w12 > 0.f) seg_d2_grad(px, py, x1, y1, e0.w, e1.x, e1.y, gd2 * w12, gr + 2, gr + 4);
                if (w20 > 0.f) seg_d2_grad(px, py, x2, y2, e1.z, e1.w, e2.x, gd2 * w20, gr + 4, gr + 0);
              }
            }
            // Warp sum in a fixed order, then one partial per (warp, slot)
            // in shared memory: the per-slot result does not depend on
            // scheduling. A warp with no hit leaves only zeros: no partial.
            if (__any_sync(FULL, hit)) {
              for (int c = 0; c < 6; ++c) {
                float x = gr[c];
                for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
                if (lane == 0) red[warp][j][c] = x;
              }
              mine |= 1ull << j;
            }
          }
        }
        if (lane == 0) wrote[warp] = mine;
        __syncthreads();
        for (int i = threadIdx.x; i < nc * 9; i += blockDim.x) {
          const int j = i / 9, c = i % 9;
          float acc = 0.f;
          if (c % 3 != 2) {  // z lanes get exactly zero gradient
            const int r = (c / 3) * 2 + (c % 3);
            for (int w = 0; w < nwarps; ++w) {
              if ((wrote[w] >> j) & 1ull) acc += red[w][j][r];
            }
          }
          out_tile[(size_t)(c0 + j) * 9 + c] = acc;
        }
      });
}

}  // namespace

// tile * tile a multiple of 32, at most 256. keep_out: null, or (B, A, kw,
// tile * tile / 32) words for the warps' cull ballots. Returns a cudaError_t.
extern "C" int raster_ids(const float* fv9, const int* s_face,
                          const int* start_a, const int* count_a,
                          const int* act_idx, int B, int F, int n, int A,
                          int nt, int tile, int K, float blur_px2, float znear,
                          float ndc2, float inv_sigma, float pad, int need_soft,
                          int* hard, int* soft, float* ssum, int kw,
                          unsigned* keep_out, void* stream) {
  auto kernel = !need_soft ? &raster_ids_kernel<false, 0>
                : K <= 8   ? &raster_ids_kernel<true, 8>
                           : &raster_ids_kernel<true, 0>;
  kernel<<<dim3(A, B), dim3(tile * tile), 0, static_cast<cudaStream_t>(stream)>>>(
      fv9, s_face, start_a, count_a, act_idx, F, n, A, nt, tile, K, blur_px2,
      znear, ndc2, inv_sigma, pad, hard, soft, ssum, kw, keep_out);
  return (int)cudaGetLastError();
}

// keep_out: null, or (B, A, ceil(cap / 32), tile * tile / 32) ballot words.
extern "C" int coverage_grad(const float* fv9, const int* s_face,
                             const int* start_a, const int* count_a,
                             const int* act_idx, const float* g, int B, int F,
                             int n, int A, int nt, int tile, int cap,
                             float blur_px2, float znear, float ndc2,
                             float inv_sigma, float pad, float* out,
                             unsigned* keep_out, void* stream) {
  const dim3 grid(A, B);
  const dim3 block(tile * tile);
  coverage_grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      fv9, s_face, start_a, count_a, act_idx, g, F, n, A, nt, tile, cap,
      blur_px2, znear, ndc2, inv_sigma, pad, out, keep_out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of K1 soft (K <= 8), K1 depth-only and K2 at
// tile * tile threads, into out[0..2]. Returns a cudaError_t.
extern "C" int raster_blocks_per_sm(int tile, int* out) {
  const int threads = tile * tile;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 0, raster_ids_kernel<true, 8>, threads, 0);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, raster_ids_kernel<false, 0>, threads, 0);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, coverage_grad_kernel, threads, 0);
  }
  return (int)e;
}
