// PCF shadow-map gradient scatter for Hopper (sm_90a): the CUDA counterpart
// of harp_tpu/render/pallas/pcf_grad_kernel.py (K3).
//
//   dpad[b, yc + di, xc + dj] += upd[b, i, 3 * (di + 1) + (dj + 1)]
//
// on the (B, Hl + 4, Hl + 4) twice-edge-padded light depth map.
//
// The TPU kernel keeps a frame's map in VMEM for the frame's whole grid and
// uses the locality of the taps: a camera tile's 256 pixels land in a few
// rows of the light map. Here each block owns a band of rows of one frame's
// map, held in shared memory, and walks a share of the frame's pixels in
// entry order, adding every tap that lands in its band. The pre-pass gives
// each group of 32 pixels its least and largest centre row, so a warp skips
// the groups that miss its band after one ballot over 32 of them, and loads
// two groups that reach it at once: the centres into registers, the updates
// (288 contiguous floats a group) into shared memory by cp.async.
//
// The sum is order-free. Each update is rounded once to fixed point,
// q = rint(u * 2^s), an int64 (u * 2^s is exact in float32 where it
// matters, and one conversion rounds it), and added as an integer. Integer addition is associative, so the sum does not depend on
// which block, warp or atomic runs first: dpad is the same bits on every
// run, with no sort and no float atomic.
// - A warp whose 32 pixels share one centre (the background pixels'
//   pile-up on one clamped centre: up to 5e4 pixels of a frame) keeps its
//   nine sums in registers, per lane, as do the lanes of later groups on
//   that centre, and adds them to the band, one warp sum a tap, when another
//   pile-up starts or its walk ends. Other lanes add their own taps.
// - A 64-bit texel in shared memory is two 32-bit words, added with native
//   32-bit atomics and the carry out of the low word (a 64-bit shared atomic
//   is a compare-and-swap loop, which stalls where many warps hit few
//   texels). Joining the lanes that share a texel first, by
//   __match_any_sync and warp reductions, was slower than these per-lane
//   adds in trials on the H100.
// - The S blocks that share a band (S splits of the frame's groups, so that
//   the pile-up's band is spread over S SMs) add their nonzero texels to an
//   int64 map in global memory (64-bit global atomics are native); the last
//   of them, by an integer ticket, converts the band to float32 once:
//   (float)((double)acc * 2^-s).
//
// The scale. s is fixed per call by m = max |u| over the finite updates. A
// max does not depend on order; the pre-pass takes it, one partial a block,
// which every scatter block reduces the same way. With m < 2^e (frexp's
// exponent; e = 0 when m = 0) and 9N <= 2^k (N pixels a frame):
// s = 62 - k - e. Then |q| <= 2^(e+s) = 2^(62-k), and a texel, which at most
// the 9N taps of its frame can reach, sums to at most 9N * 2^(62-k) <= 2^62
// < 2^63 in magnitude: no texel overflows, even if every tap lands on it.
// rint rounds u * 2^s once, half to even, by at most 2^-(s+1) in units of
// u: about 1e-13 of m at the flagship (N = 75,776, k = 20).
//
// Non-finite updates add 0 to the integers and set flags of the texels their
// taps reach (+inf, -inf, NaN). Such a texel is written as a float sum would
// make it: NaN if a NaN or both infinities reached it, else that infinity.
// pcf_scatter_fixed_plain (render/kernels/pcf_grad_kernel.py) is int64 tensor
// code for the same function; the kernel equals it bit for bit.
//
// What bounds it: bytes. It reads yc, xc and upd (44 bytes a pixel; the
// pixels of groups that straddle two bands are read by both) and writes the
// map once.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PRE_BLOCKS = 264;  // pre-pass blocks, one partial max each
constexpr int PRE_THREADS = 1024;
constexpr int THREADS = 512;     // scatter block
constexpr int WARPS = THREADS / 32;
constexpr unsigned F_POS = 1, F_NEG = 2, F_NAN = 4;
constexpr int SMEM_MAX = 180 * 1024;  // dynamic shared memory a block may take

// Where the pieces of the scratch buffer lie, in bytes from its start.
struct Scratch {
  size_t partial, grange, gacc, gflags, tickets, bytes;
};

__host__ __device__ inline Scratch scratch_layout(int B, int N, int hp4, int nbands) {
  const size_t G = (size_t)(N + 31) / 32, cells = (size_t)hp4 * hp4;
  Scratch s;
  s.partial = 0;
  s.grange = s.partial + PRE_BLOCKS * 4;               // PRE_BLOCKS * 4 is a multiple of 8
  s.gacc = (s.grange + (size_t)B * G * 8 + 15) / 16 * 16;  // zeroed from here on
  s.gflags = s.gacc + (size_t)B * cells * 8;
  s.tickets = s.gflags + (size_t)B * ((cells + 3) / 4) * 4;
  s.bytes = (s.tickets + (size_t)B * nbands * 4 + 15) / 16 * 16;
  return s;
}

// |u|'s bits for a finite u, else 0. Non-negative floats order as their bits.
__device__ __forceinline__ unsigned finite_abs_bits(float u) {
  const unsigned b = __float_as_uint(u) & 0x7fffffffu;
  return b < 0x7f800000u ? b : 0u;
}

// frexp's exponent of the float with bits m > 0: m in [2^(e-1), 2^e).
__device__ __forceinline__ int exponent_of(unsigned m) {
  const int biased = (int)(m >> 23);
  return biased ? biased - 126 : (32 - __clz(m)) - 149;
}

// The pre-pass: zero the int64 map, its flags and the tickets; per group of
// 32 pixels (one warp's load in the scatter) the least and largest
// tap-centre row (grange), so that a band's block skips the groups that
// miss it; and per block the largest finite |u| (partial).
__global__ void __launch_bounds__(PRE_THREADS)
pcf_prepass_kernel(const float* __restrict__ upd, long long count, long long count4,
                   const int* __restrict__ yc, int B, int N, unsigned* __restrict__ partial,
                   int2* __restrict__ grange, unsigned* __restrict__ zero_from,
                   long long zero_words) {
  __shared__ unsigned wmax[PRE_THREADS / 32];
  const long long tid = (long long)blockIdx.x * PRE_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * PRE_THREADS;
  uint4* z4 = reinterpret_cast<uint4*>(zero_from);  // 16-byte aligned, zero_words % 4 == 0
  for (long long i = tid; i < zero_words / 4; i += stride) z4[i] = make_uint4(0, 0, 0, 0);
  const int G = (N + 31) / 32;
  const bool vec = N % 4 == 0 && reinterpret_cast<size_t>(yc) % 16 == 0;
  for (long long g = tid; g < (long long)B * G; g += stride) {  // a thread a group
    const int b = (int)(g / G), i0 = (int)(g % G) * 32, n = min(32, N - i0);
    const int* y = yc + (size_t)b * N + i0;
    int lo = 0x7fffffff, hi = -1;
    if (vec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (4 * j < n) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(y) + j);
          lo = min(lo, min(min(v.x, v.y), min(v.z, v.w)));
          hi = max(hi, max(max(v.x, v.y), max(v.z, v.w)));
        }
      }
    } else {
      for (int j = 0; j < n; ++j) {
        lo = min(lo, __ldg(y + j));
        hi = max(hi, __ldg(y + j));
      }
    }
    grange[g] = make_int2(lo, hi);
  }
  const float4* u4 = reinterpret_cast<const float4*>(upd);
  unsigned m = 0;
#pragma unroll 4
  for (long long i = tid; i < count4; i += stride) {
    const float4 q = __ldg(u4 + i);
    m = max(m, max(max(finite_abs_bits(q.x), finite_abs_bits(q.y)),
                   max(finite_abs_bits(q.z), finite_abs_bits(q.w))));
  }
  for (long long i = count4 * 4 + tid; i < count; i += stride)
    m = max(m, finite_abs_bits(__ldg(upd + i)));
  m = __reduce_max_sync(FULL, m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < PRE_THREADS / 32; ++w) m = max(m, wmax[w]);
    partial[blockIdx.x] = m;
  }
}

// A pixel of a group: its centre, and its nine updates in shared memory.
struct Pixel {
  int y, x;
  const float* u;
};

// Copy the updates of the group of 32 pixels from i0 into shared memory
// (cp.async, 16 bytes a copy where they are aligned): the group's 288
// floats are contiguous, so the warp's copies are coalesced, and each lane
// then reads its own nine without bank conflicts (stride 9).
__device__ __forceinline__ void stage_updates(float* dst, const float* ub, int i0, int N,
                                              bool vec, int lane) {
  const int n = min(32, N - i0) * 9;
  const float* src = ub + (size_t)i0 * 9;
  if (vec) {
    for (int j = lane * 4; j < n; j += 128) __pipeline_memcpy_async(dst + j, src + j, 16);
  } else {
    for (int j = lane; j < n; j += 32) __pipeline_memcpy_async(dst + j, src + j, 4);
  }
}

__device__ __forceinline__ Pixel load_pixel(const int* yc, const int* xc, const float* stage,
                                            int i, int N, int lane) {
  const bool live = i < N;
  // Centres lie in [1, Hl + 2]: -8 is no row's.
  return {live ? __ldg(yc + i) : -8, live ? __ldg(xc + i) : 0, stage + lane * 9};
}

// q = rint(u * 2^s), half to even: u * 2^s1 * 2^s2 (s = s1 + s2, each
// power a float) is exact in float32 wherever it can round to a nonzero q
// (a power-of-two product is exact unless it leaves the normal range; below
// it |u * 2^s| < 2^-126 rounds to 0 either way, and |q| <= 2^62 stays below
// the float maximum), and the conversion rounds it once. A non-finite u
// flags its texel and gives 0.
__device__ __forceinline__ long long fixed(float u, float f1, float f2, unsigned* flags,
                                           int cell) {
  const unsigned b = __float_as_uint(u);
  if ((b & 0x7f800000u) == 0x7f800000u) {
    const unsigned f = (b & 0x7fffffu) ? F_NAN : ((b >> 31) ? F_NEG : F_POS);
    atomicOr(flags + (cell >> 2), f << ((cell & 3) * 8));
    return 0;
  }
  return __float2ll_rn(__fmul_rn(__fmul_rn(u, f1), f2));
}

__device__ __forceinline__ long long warp_sum(long long q) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) q += __shfl_xor_sync(FULL, q, d);
  return q;
}

// acc[cell] += q on a 64-bit texel kept as two 32-bit words (low, high).
// The low word's old value gives the carry; the pair holds the sum modulo
// 2^64 whatever the order of the adds.
__device__ __forceinline__ void add64(unsigned* acc, int cell, long long q) {
  const unsigned long long u = (unsigned long long)q;
  const unsigned lo = (unsigned)u, hi = (unsigned)(u >> 32);
  const unsigned old = atomicAdd(acc + 2 * cell, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(acc + 2 * cell + 1, up);
}

// Grid (bands, B, S). Block (band, b, z) owns rows [r0, r0 + rows) of frame
// b's padded map and adds the groups g with g % S == z.
__global__ void __launch_bounds__(THREADS, 2)
pcf_scatter_kernel(const int* __restrict__ yc, const int* __restrict__ xc,
                   const float* __restrict__ upd, int N, int hp4, int band, int k,
                   unsigned char* __restrict__ scratch, float* __restrict__ dpad) {
  extern __shared__ unsigned acc[];  // (band, hp4) fixed point: low, high words
  __shared__ __align__(16) float stage[WARPS][2][32 * 9];  // two groups' updates a warp
  __shared__ unsigned wmax[WARPS];
  __shared__ bool last;
  unsigned* flags = acc + 2 * band * hp4;  // a byte a texel
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y, r0 = blockIdx.x * band, S = gridDim.z;
  const int rows = min(band, hp4 - r0);
  const int cells = rows * hp4;
  const Scratch sc = scratch_layout(gridDim.y, N, hp4, gridDim.x);
  const unsigned* partial = reinterpret_cast<const unsigned*>(scratch + sc.partial);
  for (int i = t; i < 2 * cells; i += THREADS) acc[i] = 0u;
  for (int i = t; i < (cells + 3) / 4; i += THREADS) flags[i] = 0u;

  unsigned m = t < PRE_BLOCKS ? partial[t] : 0u;
  m = __reduce_max_sync(FULL, m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  m = 0;
  for (int w = 0; w < WARPS; ++w) m = max(m, wmax[w]);
  const int s = 62 - k - (m ? exponent_of(m) : 0);
  // 2^s as two float factors: s lies in [-86, 210], each half in [-43, 105].
  const float f1 = __int_as_float(((s >> 1) + 127) << 23);
  const float f2 = __int_as_float((s - (s >> 1) + 127) << 23);

  const int* ycb = yc + (size_t)b * N;
  const int* xcb = xc + (size_t)b * N;
  const float* ub = upd + (size_t)b * N * 9;
  const int G = (N + 31) / 32;
  const int2* gr = reinterpret_cast<const int2*>(scratch + sc.grange) + (size_t)b * G;

  // A pile-up (the whole warp on one centre) is summed in registers, per
  // lane and tap: pend is its centre (warp-uniform), -1 for none.
  long long pile[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) pile[j] = 0;
  int pend = -1;
  auto flush = [&]() {
    if (pend < 0) return;
    const int py = pend / hp4, px = pend - py * hp4;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = py + tap / 3 - 1 - r0;
      if (r >= 0 && r < rows) {
        const long long q = warp_sum(pile[tap]);
        if (lane == 0) add64(acc, r * hp4 + px + tap % 3 - 1, q);
      }
      pile[tap] = 0;
    }
    pend = -1;
  };

  auto add_pixel = [&](const Pixel& p) {
    const bool near = p.y + 1 >= r0 && p.y - 1 < r0 + rows;
    const int c = p.y * hp4 + p.x, c0 = __shfl_sync(FULL, c, 0);
    if (__all_sync(FULL, near && c == c0) && c0 != pend) {
      flush();
      pend = c0;
    }
    const bool piled = near && c == pend;  // a lane on the pile-up's centre
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = p.y + tap / 3 - 1 - r0;
      if (!near || r < 0 || r >= rows) continue;
      const int cell = r * hp4 + p.x + tap % 3 - 1;
      const long long q = fixed(p.u[tap], f1, f2, flags, cell);
      if (piled) pile[tap] += q; else add64(acc, cell, q);
    }
  };

  // Each warp takes windows of 32 groups, finds by one ballot the block's
  // groups whose rows reach the band, and walks them in order, two at a
  // time: both groups' loads are in flight before either is added.
  const bool vec = N % 4 == 0 && reinterpret_cast<size_t>(upd) % 16 == 0;
  float* sa = stage[warp][0];
  float* sb = stage[warp][1];
  for (int g0 = warp * 32; g0 < G; g0 += THREADS) {
    bool reach = false;
    if (g0 + lane < G && (g0 + lane) % S == (int)blockIdx.z) {
      const int2 r = __ldg(gr + g0 + lane);
      reach = r.y + 1 >= r0 && r.x - 1 < r0 + rows;
    }
    unsigned mask = __ballot_sync(FULL, reach);
    while (mask) {
      const int ia = (g0 + __ffs(mask) - 1) * 32;
      mask &= mask - 1;
      const int ib = mask ? (g0 + __ffs(mask) - 1) * 32 : -1;
      if (ib >= 0) mask &= mask - 1;
      stage_updates(sa, ub, ia, N, vec, lane);
      if (ib >= 0) stage_updates(sb, ub, ib, N, vec, lane);
      __pipeline_commit();
      const Pixel pa = load_pixel(ycb, xcb, sa, ia + lane, N, lane);
      const Pixel pb = load_pixel(ycb, xcb, sb, ib >= 0 ? ib + lane : N, N, lane);
      __pipeline_wait_prior(0);
      __syncwarp();
      add_pixel(pa);
      if (ib >= 0) add_pixel(pb);
      __syncwarp();  // the next pair overwrites the stage
    }
  }
  flush();
  __syncthreads();

  // Add the band to the frame's int64 map; the last of the band's S blocks
  // converts it.
  const size_t off = (size_t)b * hp4 * hp4 + (size_t)r0 * hp4;  // the band's first texel
  unsigned long long* gacc = reinterpret_cast<unsigned long long*>(scratch + sc.gacc);
  unsigned* gflags = reinterpret_cast<unsigned*>(scratch + sc.gflags) + (size_t)b * ((hp4 * hp4 + 3) / 4);
  for (int i = t; i < cells; i += THREADS) {
    const unsigned long long a = ((unsigned long long)acc[2 * i + 1] << 32) | acc[2 * i];
    if (a) atomicAdd(gacc + off + i, a);
    const unsigned f = (flags[i >> 2] >> ((i & 3) * 8)) & 0xffu;
    const int j = r0 * hp4 + i;  // the texel in the frame
    if (f) atomicOr(gflags + (j >> 2), f << ((j & 3) * 8));
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    unsigned* tickets = reinterpret_cast<unsigned*>(scratch + sc.tickets);
    last = atomicAdd(tickets + b * gridDim.x + blockIdx.x, 1u) == (unsigned)S - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double unscale = ldexp(1.0, -s);
  float* out = dpad + off;
  for (int i = t; i < cells; i += THREADS) {
    const long long a = (long long)__ldcg(gacc + off + i);
    float v = __double2float_rn(__ll2double_rn(a) * unscale);
    const int j = r0 * hp4 + i;
    const unsigned f = (__ldcg(gflags + (j >> 2)) >> ((j & 3) * 8)) & 0xffu;
    if (f) {
      v = (f & F_NAN) || (f == (F_POS | F_NEG)) ? __uint_as_float(0x7fc00000u)
          : (f & F_POS ? __uint_as_float(0x7f800000u) : __uint_as_float(0xff800000u));
    }
    out[i] = v;
  }
}

// The launch: bands of a frame ~ SMs / B (rows a band at most what shared
// memory holds: 8 bytes of sum and 1 of flags a texel), and S splits of the
// frame's groups, about 8 blocks per SM in all, so that the band of the
// pile-up is spread over S SMs. Returns false if not one row fits.
bool layout(int B, int N, int hp4, int* band, int* nbands, int* splits, size_t* smem) {
  static int sms = 0;  // the card's SM count, read once
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const int band_max = SMEM_MAX / (hp4 * 9 + 4);
  if (band_max < 1) return false;
  const int want = std::max(1, std::min(hp4, sms / B));
  *band = std::min(band_max, (hp4 + want - 1) / want);
  *nbands = (hp4 + *band - 1) / *band;
  const int groups = (N + 31) / 32;
  *splits = std::max(1, std::min(groups, 8 * sms / (B * *nbands)));
  *smem = (size_t)*band * hp4 * 8 + (size_t)((*band * hp4 + 3) / 4) * 4;
  return true;
}

}  // namespace

// Bytes of scratch that pcf_scatter takes for B frames of N pixels.
extern "C" long long pcf_scatter_scratch_bytes(int B, int N, int hl) {
  int band, nbands, splits;
  size_t smem;
  if (B <= 0 || N <= 0 || hl <= 0 || !layout(B, N, hl + 4, &band, &nbands, &splits, &smem))
    return -1;
  return (long long)scratch_layout(B, N, hl + 4, nbands).bytes;
}

// The launch of B frames of N pixels on an (hl + 4)^2 map: out = {rows a
// band, bands a frame, splits, dynamic shared bytes a block, resident
// blocks per SM}.
extern "C" int pcf_scatter_layout(int B, int N, int hl, int* out) {
  int band, nbands, splits;
  size_t smem;
  if (B <= 0 || N <= 0 || hl <= 0 || !layout(B, N, hl + 4, &band, &nbands, &splits, &smem))
    return (int)cudaErrorInvalidValue;
  out[0] = band;
  out[1] = nbands;
  out[2] = splits;
  out[3] = (int)smem;
  cudaError_t err = cudaFuncSetAttribute(
      pcf_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 4, pcf_scatter_kernel,
                                                            THREADS, smem);
}

// yc, xc (B, N) int32 tap centres in [1, hl + 2]; upd (B, N, 9) f32;
// scratch (pcf_scatter_scratch_bytes(B, N, hl),) 16-byte aligned; dpad
// (B, hl + 4, hl + 4) f32, every texel written. N > 0.
extern "C" int pcf_scatter(const int* yc, const int* xc, const float* upd, int B, int N,
                           int hl, void* scratch, float* dpad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hp4 = hl + 4;
  int band, nbands, splits;
  size_t smem;
  if (B <= 0 || N <= 0 || hl <= 0 || !layout(B, N, hp4, &band, &nbands, &splits, &smem))
    return (int)cudaErrorInvalidValue;
  int k = 0;  // 9N <= 2^k
  while ((1ll << k) < 9ll * N) ++k;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const Scratch sc = scratch_layout(B, N, hp4, nbands);
  // The int64 map, its flags and the tickets: the scratch from gacc on.
  const long long zero_words = (long long)(sc.bytes - sc.gacc) / 4;

  const long long count = 9ll * B * N;
  const long long count4 = (reinterpret_cast<size_t>(upd) % 16) ? 0 : count / 4;
  pcf_prepass_kernel<<<PRE_BLOCKS, PRE_THREADS, 0, st>>>(
      upd, count, count4, yc, B, N, reinterpret_cast<unsigned*>(base + sc.partial),
      reinterpret_cast<int2*>(base + sc.grange), reinterpret_cast<unsigned*>(base + sc.gacc),
      zero_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static size_t smem_allowed = 0;  // raised once, not on every launch
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(pcf_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  pcf_scatter_kernel<<<dim3(nbands, B, splits), THREADS, smem, st>>>(yc, xc, upd, N, hp4, band,
                                                                     k, base, dpad);
  return (int)cudaGetLastError();
}
