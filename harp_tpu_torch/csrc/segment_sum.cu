// Fixed-order segmented row sum for Hopper (sm_90a).
//
//   out[r, :] = sum of values[j, :] over the entries j with key[j] == r
//
// It is the backward of every row gather on the fit step's path (texture
// sampling, the packed-attribute and face-row gathers, the texture
// regularisers), the forward of the vertex-normal accumulation and K2's
// vertex scatter. harp_tpu has no Pallas kernel for it: there XLA transposes
// the gathers into scatter-adds.
//
// The caller supplies the entries in key order: skey (the keys, sorted) and
// perm (the entry each sorted position came from, from a stable sort). The
// sum of a row is then taken in an order fixed by the input alone, so the
// result is the same bits from run to run. There are no float atomics.
//
// Pass 1 cuts the sorted entries into chunks of E = 256, one block a chunk.
// The block reads the chunk's keys once and works out its segment structure
// once: where segments start and end, which ones cross into the chunks
// before and after, and the rows it must zero (the empty rows after each key
// whose last entry lies in the chunk; for the first chunk also the rows below
// the first key), so out needs no memset. It stages the chunk's rows in
// shared memory with whole-row loads (16-byte vectors at C = 24, 4-byte
// loads at the other widths), transposed to one line
// per channel, and takes every channel's segmented scan in one pass between
// one pair of barriers: warp w scans channels w, w + 8, ...; lane l adds its
// 8 consecutive entries in order and the warp joins the lanes by a shuffle
// scan. A segment wholly inside the chunk is written as a whole output row.
// A segment that crosses a chunk edge leaves the chunk's partial in head (the
// chunk's first segment) or tail (its last). Channels are staged 32 at a
// time: one slab for every width the step uses (3, 9, 24), which are
// compiled as constants; any other C takes the generic instance.
//
// Pass 2 folds each crossing segment's partials in chunk order: the tail
// of the chunk where it starts, then the heads of the chunks after it. A
// warp a chunk edge finds the segments that start before the edge; up to 64
// partials the warp folds them in order, a longer run (a run of 10^5
// entries: the background pixels of a frame all sample one clamped texel)
// is folded by the whole block in a fixed number of contiguous groups, each
// added in order, then the group sums in order. The order of addition
// depends on the input alone.
//
// What bounds it: bytes. It reads M * (C + 2) * 4 bytes (values, skey, perm)
// and writes R * C * 4; the arithmetic is one add per value. The rows come
// through perm, in 32-byte sectors: whole ones at C = 24 (96-byte rows),
// partly used ones at C = 3 and 9. cp.async is not used: the rows are
// transposed on their way into shared memory, which a pass through
// registers does at no cost.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int E = 256;            // entries per chunk: one block of E threads
constexpr int WARPS = E / 32;
constexpr int PER_LANE = E / 32;  // entries one lane scans: 8
constexpr int SLAB = 32;          // channels staged at once
// One line per channel. Entry e sits at e + e / 8, so lane l's entries
// 8l + k lie in bank (9l + k) mod 32 and the scan reads without conflict;
// the odd line length spreads one entry's channels over the banks.
constexpr int LINE = E + E / PER_LANE + 1;

__device__ __forceinline__ int tpos(int e) { return e + (e >> 3); }

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// CT: C as a constant (0: read the argument). V: floats a load (4 or 1), C % V == 0.
template <int CT, int V>
__global__ void __launch_bounds__(E)
chunk_sums_kernel(const int* __restrict__ skey, const int* __restrict__ perm,
                  const float* __restrict__ values, int M, int C_, int R,
                  float* __restrict__ out, float* __restrict__ head,
                  float* __restrict__ tail) {
  constexpr int CS = (CT > 0 && CT < SLAB) ? CT : SLAB;  // lines of the tile
  constexpr int ITEMS = CS / V;  // vectors a thread stages per slab, at most
  const int C = CT > 0 ? CT : C_;
  __shared__ float tile[CS][LINE];
  __shared__ int keys[E + 2];       // skey[c0 - 1 .. c0 + n]; -1 and R beyond the ends
  __shared__ int rows[E];           // perm of the chunk's entries
  __shared__ unsigned heads[WARPS];  // bit b of word w: entry 32w + b starts a segment here
  __shared__ int end_entry[E];      // the chunk's segment ends, in entry order
  __shared__ unsigned char end_kind[E];  // 0: whole segment; 1: head partial; 2: tail; 3: both
  __shared__ int gap_at[E];         // exclusive prefix of the gaps' lengths, in floats
  __shared__ int gap_from[E];       // where each gap starts in out, in floats
  __shared__ int wsum[2][WARPS];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = blockIdx.x, c0 = chunk * E;
  const int n = min(E, M - c0);
  const bool live = t < n;
  if (live) {
    keys[t + 1] = skey[c0 + t];
    rows[t] = perm[c0 + t];
  }
  if (t == 0) keys[0] = c0 > 0 ? skey[c0 - 1] : -1;
  if (t == E - 1) keys[n + 1] = c0 + n < M ? skey[c0 + n] : R;
  __syncthreads();

  // Stage a slab's rows: first the loads (issued before anything waits on
  // them), then the stores into the tile.
  float x[ITEMS][V];
  auto load_slab = [&](int s0, int nv) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = t + it * E, e = idx / nv, v = idx - e * nv;
      if (e < n) load_vec<V>(values + (size_t)rows[e] * C + s0 + v * V, x[it]);
    }
  };
  auto store_slab = [&](int nv) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = t + it * E, e = idx / nv, v = idx - e * nv;
      if (e < n) {
#pragma unroll
        for (int k = 0; k < V; ++k) tile[v * V + k][tpos(e)] = x[it][k];
      }
    }
  };
  load_slab(0, min(C, SLAB) / V);

  // The chunk's segment structure, once for all channels.
  const int key = live ? keys[t + 1] : -1;
  const int next = keys[t + 2];
  const int key0 = keys[1], keyl = keys[n];
  const bool gend = live && next != key;  // the last entry of its key
  const bool lhead = live && (t == 0 || keys[t] != key);
  const bool lend = live && (t == n - 1 || next != key);
  int kind = 0;
  if (lend) {
    if (key == key0 && keys[0] == key0) kind |= 1;
    if (key == keyl && keys[n + 1] == keyl) kind |= 2;
  }
  const int gap = gend ? (next - key - 1) * C : 0;
  const int ia = warp_inclusive(lend ? 1 : 0, lane);
  const int ig = warp_inclusive(gap, lane);
  const unsigned hb = __ballot_sync(FULL, lhead);
  if (lane == 31) {
    wsum[0][warp] = ia;
    wsum[1][warp] = ig;
  }
  if (lane == 0) heads[warp] = hb;
  __syncthreads();
  int pa = 0, pg = 0, nends = 0, zeros = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) {
      pa += wsum[0][w];
      pg += wsum[1][w];
    }
    nends += wsum[0][w];
    zeros += wsum[1][w];
  }
  if (lend) {
    end_entry[pa + ia - 1] = t;
    end_kind[pa + ia - 1] = (unsigned char)kind;
  }
  gap_at[t] = pg + ig - gap;
  gap_from[t] = (key + 1) * C;
  __syncthreads();

  for (int s0 = 0; s0 < C; s0 += SLAB) {
    const int cs = CT > 0 ? CS : min(SLAB, C - s0);
    const int nv = cs / V;
    if (s0 > 0) load_slab(s0, nv);
    if (s0 == 0) {
      // The gaps this chunk owns, V floats a store (gaps start and end on
      // row boundaries, and C % V == 0).
      const float z[V] = {};
      for (int i = t * V; i < zeros; i += E * V) {
        int lo = 0, hi = E - 1;  // the last thread whose gap starts at or before i
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (gap_at[mid] <= i) lo = mid; else hi = mid - 1;
        }
        store_vec<V>(out + gap_from[lo] + (i - gap_at[lo]), z);
      }
      if (chunk == 0) {
        for (int i = t * V; i < key0 * C; i += E * V) store_vec<V>(out + i, z);
      }
    }
    store_slab(nv);
    __syncthreads();

    // Segmented inclusive scans, one channel a warp at a time.
    const unsigned hm = (heads[lane >> 2] >> ((lane & 3) * 8)) & 0xffu;
    for (int c = warp; c < cs; c += WARPS) {
      float* line = tile[c];
      float v[PER_LANE];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const float y = line[tpos(lane * PER_LANE + k)];
        acc = (hm >> k) & 1u ? y : acc + y;
        v[k] = acc;
      }
      float s = acc;
      int f = hm != 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float so = __shfl_up_sync(FULL, s, d);
        const int fo = __shfl_up_sync(FULL, f, d);
        if (lane >= d) {
          if (!f) s = so + s;
          f |= fo;
        }
      }
      const float carry = __shfl_up_sync(FULL, s, 1);
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        if (lane > 0 && !(hm & ((2u << k) - 1u))) v[k] = carry + v[k];
        line[tpos(lane * PER_LANE + k)] = v[k];
      }
    }
    __syncthreads();

    // Whole rows out: each segment end's sums, V floats a store.
    for (int idx = t; idx < nends * nv; idx += E) {
      const int i = idx / nv, vv = idx - i * nv;
      const int e = end_entry[i], k = end_kind[i];
      float y[V];
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = tile[vv * V + j][tpos(e)];
      const int col = s0 + vv * V;
      if (k == 0) store_vec<V>(out + (size_t)keys[e + 1] * C + col, y);
      if (k & 1) store_vec<V>(head + (size_t)chunk * C + col, y);
      if (k & 2) store_vec<V>(tail + (size_t)chunk * C + col, y);
    }
    if (s0 + SLAB < C) __syncthreads();  // the next slab reuses the tile
  }
}

// The last chunk that holds key, for a segment that crosses the edge after
// chunk c. Gallops over chunk ends (a short segment ends in the next chunk:
// one load), then bisects.
__device__ int last_chunk(const int* skey, int M, int c, int key) {
  const int nchunks = (M + E - 1) / E;
  auto holds = [&](int j) { return skey[min((j + 1) * E, M) - 1] == key; };
  int lo = c, d = 1;  // chunk lo's last entry holds key
  while (lo + d < nchunks && holds(lo + d)) {
    lo += d;
    d *= 2;
  }
  int hi = min(lo + d, nchunks);  // chunk hi's last entry does not, or hi = nchunks
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (holds(mid)) lo = mid; else hi = mid;
  }
  // The run ends in chunk lo + 1, or exactly at chunk lo's end.
  return lo + 1 < nchunks && skey[(lo + 1) * E] == key ? lo + 1 : lo;
}

// One warp per chunk edge: the segment across the edge after chunk c, if it
// starts in chunk c, is folded from chunk c's tail partial and the head
// partials of the chunks it covers after c, in chunk order. Up to SHORT
// partials the warp folds them, a lane a channel; a longer run is folded by
// the whole block, cut into G contiguous groups of one channel each (G = E /
// C threads a channel, each group added in order), then the G group sums in
// order. Which way a segment is folded depends on its length alone.
constexpr int SHORT = 64;

__global__ void __launch_bounds__(E)
cross_sums_kernel(const int* __restrict__ skey, int M, int C, int nchunks,
                  const float* __restrict__ head, const float* __restrict__ tail,
                  float* __restrict__ out) {
  __shared__ float gsum[E];
  __shared__ int2 long_run[WARPS];  // (first chunk, partials) of the block's long runs
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.x * WARPS + warp;  // the edge after chunk c
  int key = -1, np = 0;
  if (lane == 0 && c < nchunks - 1) {
    key = skey[(c + 1) * E - 1];
    if (skey[(c + 1) * E] == key && !(c > 0 && skey[c * E - 1] == key))
      np = last_chunk(skey, M, c, key) - c + 1;
  }
  key = __shfl_sync(FULL, key, 0);
  np = __shfl_sync(FULL, np, 0);
  if (np > 0 && np <= SHORT) {
    for (int ch = lane; ch < C; ch += 32) {
      float acc = tail[(size_t)c * C + ch];
      for (int j = 1; j < np; ++j) acc = acc + head[(size_t)(c + j) * C + ch];
      out[(size_t)key * C + ch] = acc;
    }
  }
  if (lane == 0) long_run[warp] = make_int2(c, np > SHORT ? np : 0);
  __syncthreads();
  const int G = C <= E ? E / C : 1;
  const int step = C > E ? E : C;  // one round unless C > E
  for (int w = 0; w < WARPS; ++w) {
    const int c0 = long_run[w].x, n = long_run[w].y;
    if (n == 0) continue;
    const int len = (n + G - 1) / G;
    float* row = out + (size_t)skey[(c0 + 1) * E - 1] * C;
    for (int ch0 = 0; ch0 < C; ch0 += step) {
      const int g = G > 1 ? t / C : 0;
      const int ch = ch0 + (G > 1 ? t % C : t);
      float acc = 0.f;
      if (g < G && ch < C) {
        const int j0 = g * len, j1 = min(n, j0 + len);
        if (j0 == 0) acc = tail[(size_t)c0 * C + ch];
#pragma unroll 8
        for (int j = max(j0, 1); j < j1; ++j) acc = acc + head[(size_t)(c0 + j) * C + ch];
      }
      if (G == 1) {
        if (ch < C) row[ch] = acc;
      } else {
        gsum[t] = acc;
        __syncthreads();
        if (t < C) {
          float s = gsum[t];
          for (int k = 1; k < G; ++k) s = s + gsum[k * C + t];
          row[t] = s;
        }
        __syncthreads();
      }
    }
  }
}

template <int CT, int V>
void launch_chunks(int nchunks, cudaStream_t s, const int* skey, const int* perm,
                   const float* values, int M, int C, int R, float* out,
                   float* head, float* tail) {
  chunk_sums_kernel<CT, V><<<nchunks, E, 0, s>>>(skey, perm, values, M, C, R, out,
                                                 head, tail);
}

}  // namespace

extern "C" int segment_sum_chunk() { return E; }

// Resident blocks per SM of the chunk kernel at C = 3, 9 and 24, into
// out[0..2].
extern "C" int segment_sum_blocks_per_sm(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 0, chunk_sums_kernel<3, 1>, E, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, chunk_sums_kernel<9, 1>, E, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, chunk_sums_kernel<24, 4>, E, 0);
  return (int)e;
}

// skey, perm (M,) int32; values (M, C) f32; out (R, C) f32, every row
// written; head, tail (ceil(M / E), C) f32 scratch. Keys must lie in [0, R),
// R * C < 2^31, M > 0.
extern "C" int segment_sum(const int* skey, const int* perm, const float* values,
                           int M, int C, int R, float* out, float* head,
                           float* tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int nchunks = (M + E - 1) / E;
  if (C == 3) launch_chunks<3, 1>(nchunks, s, skey, perm, values, M, C, R, out, head, tail);
  else if (C == 9) launch_chunks<9, 1>(nchunks, s, skey, perm, values, M, C, R, out, head, tail);
  else if (C == 24 && reinterpret_cast<size_t>(values) % 16 == 0)  // whole rows of 16-byte loads
    launch_chunks<24, 4>(nchunks, s, skey, perm, values, M, C, R, out, head, tail);
  else launch_chunks<0, 1>(nchunks, s, skey, perm, values, M, C, R, out, head, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  cross_sums_kernel<<<(nchunks - 1 + WARPS - 1) / WARPS, E, 0, s>>>(skey, M, C, nchunks, head,
                                                                   tail, out);
  return (int)cudaGetLastError();
}
