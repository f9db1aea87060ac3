// Symmetric per-level int8 quantization of the FPN levels P2-P5 for sm_90a:
// the tables an eval with int8_roi_pool pools from.
//
// Replaces hnd_ghnd_tpu/ops/roi_align.py:quantize_fpn_levels (XLA ops, not
// a Pallas kernel; it feeds the int8 tables of pallas_roi.py:_roi_kernel).
// Per level l over the whole batch: s_l = max|f| / 127 (1 where that max is
// 0 or NaN), q = clamp(round-half-even(f / s_l), -127, 127), and q = 0
// where f / s_l is NaN (a NaN, or inf / inf), as XLA's convert of NaN gives
// the JAX package on the CPU (ROADMAP C12).
//
// Bound on the H100: bytes.  At B=8 on the 832x1344 bucket the four levels
// hold 8 x 92,820 pixels x C=256 float32 (760 MB) and get 190 MB of codes:
// 0.284 ms for a single pass at 3.35 TB/s.  The abs-max must finish before
// the first code, and the levels do not fit in the 50 MB L2, so an exact
// kernel reads them twice: (2 x 760 + 190) MB, 0.511 ms, is its floor.
//
// A 16-byte memset and two launches on one stream; the scales never leave
// the device.  Both kernels run persistent grids (the blocks the device
// holds at once, from its SM count and the occupancy API, read once per
// device) over one list of equal work items that spans the four levels, so
// the work splits by bytes and not by level.
//   1. abs-max: tiles of 8192 floats, each thread with eight 16-byte loads
//      in flight.  |f| is the float's bits without the sign bit: their
//      unsigned order is the floats' order with every NaN above +inf, so an
//      integer max propagates NaN.  A running max per thread and level,
//      then a warp (redux) and block reduction, and one atomicMax per block
//      and level it touched: exact in any order.
//   2. codes.  From the NHWC view of contiguous NCHW maps (what the FPN
//      gives): an item is one image x 256 channels (the rest of C in the
//      last group) x 32 pixels, whose NHWC codes are one contiguous run of
//      8 KB when C = 256.  Thread (pq, cq) loads pixels 4pq..4pq+3 of
//      channels 4cq..4cq+3 and 4(cq+32)..+3, eight float4 (8 threads read
//      128 contiguous bytes of a channel row), codes them in registers,
//      packs each pixel's 4 channels into a word with byte permutes and
//      stores the words into a [32 pixel][256 channel] int8 tile whose
//      16-byte chunks are XOR-swizzled by pixel / 4, so that the word
//      stores and the 16-byte reads after them are free of bank conflicts.
//      The block then writes the tile out in 16-byte vectors along the NHWC
//      run.  While one item converts and stores, the next item's eight
//      float4 are already loading into a second set of registers: a thread
//      uses only the floats it loaded (the transpose is done on the int8
//      codes), so staging them in shared memory would add its traffic for
//      nothing.  The tile has two buffers: one barrier per item.
//      From contiguous NHWC: the same walk over tiles of 8192 floats, each
//      float4's codes packed into a word of the tile, then 16-byte vectors
//      out.
//   Levels whose rows do not split into 16-byte vectors (H*W not a multiple
//   of 4 or C of 16 from NCHW, an unaligned pointer) and the partial last
//   tile of an NHWC level take a scalar path in the same kernels.  The
//   codes pass walks the list from its end, starting on the bytes the
//   abs-max pass read last, which L2 may still hold (0.2% less card time
//   from NCHW, 1.4% from NHWC, in turns against the walk from the start).
// The design before this one (a 32 x 32 tile per block for the NCHW codes,
// 185,728 blocks of four scalar loads a thread; the same 1,056 abs-max
// blocks for every level) took 0.95 ms of card time from NCHW; this one
// takes 0.56-0.58 ms, 88-91% of the two-pass floor (chip_roi_ab.py in turns
// on an H100 80GB HBM3 at 700 W; PERF.md).
//
// Bit-exactness with ops/roi_align.py:quantize_fpn_levels: the division is
// IEEE round-to-nearest (__fdiv_rn); the code is rounded half to even by
// adding 1.5 x 2^23 after the clamp, where the floats' spacing is 1, and
// is the low byte of the sum's bits; the abs-max ignores nothing (bucket
// padding is zeros and counts).  Build without --use_fast_math.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 4;
constexpr int kThreads = 256;
constexpr int kVec = 8;                     // float4 per thread and item
constexpr int kTile = kThreads * kVec * 4;  // floats of an abs-max / NHWC item
constexpr int kItemP = 32;                  // NCHW item: pixels
constexpr int kItemC = 256;                 // NCHW item: channels
static_assert(kItemP * kItemC == kTile, "an NCHW item is one tile of floats");
static_assert(kThreads == (kItemP / 4) * (kItemC / 8),
              "a thread: one pixel quad x two channel quads");
constexpr unsigned kAbs = 0x7fffffffu;      // the bits of |f|
constexpr float kRound = 12582912.0f;       // 1.5 x 2^23
constexpr int kMaxDevices = 64;

struct Levels {
  const float* src[kLevels];  // NHWC contiguous, or NCHW contiguous
  int8_t* dst[kLevels];       // NHWC contiguous
  int64_t n[kLevels];         // B * H_l * W_l * C
  int hw[kLevels];            // H_l * W_l
  int p_items[kLevels];       // NCHW: items of kItemP pixels per image row
  bool src16[kLevels];        // the source is 16-byte aligned
  bool vec[kLevels];          // the codes pass takes 16-byte vectors
  int tiles[kLevels + 1];     // first tile of each level (abs-max, NHWC)
  int items[kLevels + 1];     // first NCHW item of each level
  int C;
  int c_groups;               // NCHW: channel groups of kItemC
};

__device__ __forceinline__ int level_of(const int* start, int t) {
  int l = 0;
#pragma unroll
  for (int k = 1; k < kLevels; ++k) l += t >= start[k];
  return l;
}

// The bits of max|f| -> s_l: NaN fails a > 0 and gives 1.
__device__ __forceinline__ float level_scale(unsigned bits) {
  const float a = __uint_as_float(bits);
  return a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
}

// The code of v at scale s in the low byte of the result.
__device__ __forceinline__ unsigned code_bits(float v, float s) {
  float q = __fdiv_rn(v, s);
  q = q != q ? 0.0f : fminf(fmaxf(q, -127.0f), 127.0f);
  // in [2^23, 2^24) floats are the integers: the add rounds half to even
  // and leaves the code's two's complement in the low byte
  return __float_as_uint(__fadd_rn(q, kRound));
}

__device__ __forceinline__ int8_t code_byte(float v, float s) {
  return static_cast<int8_t>(static_cast<uint8_t>(code_bits(v, s)));
}

// The low bytes of a, b, c, d as one word (a lowest).
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ unsigned abs_max4(uint4 v) {
  return max(max(v.x & kAbs, v.y & kAbs), max(v.z & kAbs, v.w & kAbs));
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const Levels lv, unsigned* __restrict__ amax) {
  unsigned m[kLevels] = {0u, 0u, 0u, 0u};
  unsigned touched = 0u;
  for (int t = blockIdx.x; t < lv.tiles[kLevels]; t += gridDim.x) {
    const int l = level_of(lv.tiles, t);
    const int64_t i0 = (int64_t)(t - lv.tiles[l]) * kTile;
    const int64_t end = i0 + kTile < lv.n[l] ? i0 + kTile : lv.n[l];
    const float* __restrict__ x = lv.src[l];
    unsigned a = 0u;
    if (lv.src16[l] && end - i0 == kTile) {
      const uint4* x4 = reinterpret_cast<const uint4*>(x + i0) + threadIdx.x;
      uint4 v[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) v[u] = x4[u * kThreads];
#pragma unroll
      for (int u = 0; u < kVec; ++u) a = max(a, abs_max4(v[u]));
    } else {
      for (int64_t i = i0 + threadIdx.x; i < end; i += kThreads)
        a = max(a, __float_as_uint(x[i]) & kAbs);
    }
#pragma unroll
    for (int k = 0; k < kLevels; ++k) m[k] = k == l ? max(m[k], a) : m[k];
    touched |= 1u << l;
  }
  __shared__ unsigned s_max[kLevels][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const unsigned w = __reduce_max_sync(0xffffffffu, m[k]);
    if (lane == 0) s_max[k][warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      const unsigned w = __reduce_max_sync(
          0xffffffffu, lane < kThreads / 32 ? s_max[k][lane] : 0u);
      if (lane == 0 && (touched >> k & 1u)) atomicMax(amax + k, w);
    }
  }
}

// The codes pass walks its items from the end of the list, so that it
// starts on the bytes the abs-max pass read last, which L2 may still hold.
__device__ __forceinline__ int from_end(int total, int w) {
  return total - 1 - w;
}

// Every block reads the four scales; block 0 writes them out.
__device__ __forceinline__ void load_scales(const unsigned* amax,
                                            float* scales, float* s_scale) {
  if (threadIdx.x < kLevels) {
    const float s = level_scale(amax[threadIdx.x]);
    s_scale[threadIdx.x] = s;
    if (blockIdx.x == 0) scales[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- NCHW

struct Item {
  const float* x;  // element (c0, p0) of the image's NCHW map
  int8_t* q;       // code (p0, c0) of the image's NHWC codes
  int l;           // level
  int hw;          // H_l * W_l
  int cb;          // channels of the item
  int pb;          // pixels of the item
  bool vec;
};

__device__ __forceinline__ Item nchw_item(const Levels& lv, int w) {
  Item it;
  it.l = level_of(lv.items, w);
  int r = w - lv.items[it.l];
  const int pi = r % lv.p_items[it.l];
  r /= lv.p_items[it.l];
  const int cg = r % lv.c_groups;
  const int b = r / lv.c_groups;
  const int c0 = cg * kItemC;
  const int p0 = pi * kItemP;
  it.hw = lv.hw[it.l];
  it.cb = min(kItemC, lv.C - c0);
  it.pb = min(kItemP, it.hw - p0);
  it.x = lv.src[it.l] + ((int64_t)b * lv.C + c0) * it.hw + p0;
  it.q = lv.dst[it.l] + ((int64_t)b * it.hw + p0) * lv.C + c0;
  it.vec = lv.vec[it.l];
  return it;
}

// v[g][j]: pixels 4pq..4pq+3 of channel 4 * (cq + 32g) + j; zeros outside
// the item.
__device__ __forceinline__ void nchw_load(const Item& it, int pq, int cq,
                                          float4 (&v)[2][4]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = 4 * (cq + 32 * g);
    const bool in = c < it.cb && 4 * pq < it.pb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[g][j] = in ? *reinterpret_cast<const float4*>(
                         it.x + (int64_t)(c + j) * it.hw + 4 * pq)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The tile is [kItemP pixel][kItemC channel] bytes; the 16-byte chunk m of
// pixel row r sits at chunk m ^ ((r / 4) % 8) of the row.
__device__ __forceinline__ int swizzled(int r, int m) {
  return r * kItemC + ((m ^ ((r >> 2) & 7)) << 4);
}

__device__ __forceinline__ void nchw_codes(const float4 (&v)[2][4], float s,
                                           int pq, int cq, int8_t* tile) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int cw = cq + 32 * g;  // the word of channels 4cw..4cw+3
    const unsigned w[4] = {
        pack4(code_bits(v[g][0].x, s), code_bits(v[g][1].x, s),
              code_bits(v[g][2].x, s), code_bits(v[g][3].x, s)),
        pack4(code_bits(v[g][0].y, s), code_bits(v[g][1].y, s),
              code_bits(v[g][2].y, s), code_bits(v[g][3].y, s)),
        pack4(code_bits(v[g][0].z, s), code_bits(v[g][1].z, s),
              code_bits(v[g][2].z, s), code_bits(v[g][3].z, s)),
        pack4(code_bits(v[g][0].w, s), code_bits(v[g][1].w, s),
              code_bits(v[g][2].w, s), code_bits(v[g][3].w, s))};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * pq + k;
      *reinterpret_cast<unsigned*>(tile + swizzled(r, cw >> 2) +
                                   4 * (cw & 3)) = w[k];
    }
  }
}

__device__ __forceinline__ void nchw_out(const Item& it, int C,
                                         const int8_t* tile) {
  const int cpr = it.cb >> 4;  // 16-byte chunks per pixel
  for (int ci = threadIdx.x; ci < it.pb * cpr; ci += kThreads) {
    int r, m;
    if (cpr == kItemC / 16) {
      r = ci >> 4;
      m = ci & 15;
    } else {
      r = ci / cpr;
      m = ci - r * cpr;
    }
    *reinterpret_cast<uint4*>(it.q + (int64_t)r * C + 16 * m) =
        *reinterpret_cast<const uint4*>(tile + swizzled(r, m));
  }
}

// The scalar path: [pixel][channel] bytes, unswizzled.
__device__ __forceinline__ void nchw_codes_scalar(const Item& it, float s,
                                                  int8_t* tile) {
  for (int e = threadIdx.x; e < kItemP * kItemC; e += kThreads) {
    const int c = e / kItemP;
    const int p = e % kItemP;
    if (c < it.cb && p < it.pb)
      tile[p * kItemC + c] = code_byte(it.x[(int64_t)c * it.hw + p], s);
  }
}

__device__ __forceinline__ void nchw_out_scalar(const Item& it, int C,
                                                const int8_t* tile) {
  for (int e = threadIdx.x; e < it.pb * it.cb; e += kThreads) {
    const int p = e / it.cb;
    const int c = e - p * it.cb;
    it.q[(int64_t)p * C + c] = tile[p * kItemC + c];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
codes_nchw_kernel(const Levels lv, const unsigned* __restrict__ amax,
                  float* __restrict__ scales) {
  __shared__ __align__(16) int8_t tile[2][kItemP * kItemC];
  __shared__ float s_scale[kLevels];
  load_scales(amax, scales, s_scale);
  const int pq = threadIdx.x & 7;
  const int cq = threadIdx.x >> 3;
  const int total = lv.items[kLevels];
  int w = blockIdx.x;
  if (w >= total) return;
  Item it = nchw_item(lv, from_end(total, w));
  float4 cur[2][4], nxt[2][4];
  if (it.vec) nchw_load(it, pq, cq, cur);
  for (int buf = 0; w < total; w += gridDim.x, buf ^= 1) {
    Item next = it;
    if (w + (int)gridDim.x < total) {
      next = nchw_item(lv, from_end(total, w + gridDim.x));
      if (next.vec) nchw_load(next, pq, cq, nxt);
    }
    const float s = s_scale[it.l];
    if (it.vec) {
      nchw_codes(cur, s, pq, cq, tile[buf]);
    } else {
      nchw_codes_scalar(it, s, tile[buf]);
    }
    __syncthreads();
    if (it.vec) {
      nchw_out(it, lv.C, tile[buf]);
    } else {
      nchw_out_scalar(it, lv.C, tile[buf]);
    }
    it = next;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[g][j] = nxt[g][j];
    }
  }
}

// ---------------------------------------------------------------- NHWC

__global__ void __launch_bounds__(kThreads, 2)
codes_nhwc_kernel(const Levels lv, const unsigned* __restrict__ amax,
                  float* __restrict__ scales) {
  __shared__ __align__(16) unsigned words[2][kTile / 4];
  __shared__ float s_scale[kLevels];
  load_scales(amax, scales, s_scale);
  const int total = lv.tiles[kLevels];
  int t = blockIdx.x;
  if (t >= total) return;
  // a tile takes the vector path when its level does and it is whole
  auto whole = [&](int l, int64_t i0) {
    return lv.vec[l] && i0 + kTile <= lv.n[l];
  };
  int l = level_of(lv.tiles, from_end(total, t));
  int64_t i0 = (int64_t)(from_end(total, t) - lv.tiles[l]) * kTile;
  float4 cur[kVec], nxt[kVec];
  if (whole(l, i0)) {
    const float4* x4 = reinterpret_cast<const float4*>(lv.src[l] + i0);
#pragma unroll
    for (int u = 0; u < kVec; ++u) cur[u] = x4[u * kThreads + threadIdx.x];
  }
  for (int buf = 0; t < total; t += gridDim.x, buf ^= 1) {
    int nl = l;
    int64_t n0 = i0;
    if (t + (int)gridDim.x < total) {
      const int nt = from_end(total, t + gridDim.x);
      nl = level_of(lv.tiles, nt);
      n0 = (int64_t)(nt - lv.tiles[nl]) * kTile;
      if (whole(nl, n0)) {
        const float4* x4 = reinterpret_cast<const float4*>(lv.src[nl] + n0);
#pragma unroll
        for (int u = 0; u < kVec; ++u) nxt[u] = x4[u * kThreads + threadIdx.x];
      }
    }
    const float s = s_scale[l];
    int8_t* __restrict__ q = lv.dst[l] + i0;
    if (whole(l, i0)) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const float4 v = cur[u];
        words[buf][u * kThreads + threadIdx.x] =
            pack4(code_bits(v.x, s), code_bits(v.y, s), code_bits(v.z, s),
                  code_bits(v.w, s));
      }
    } else {
      const float* __restrict__ x = lv.src[l] + i0;
      const int64_t n = lv.n[l] - i0 < kTile ? lv.n[l] - i0 : kTile;
      for (int64_t i = threadIdx.x; i < n; i += kThreads)
        q[i] = code_byte(x[i], s);
    }
    __syncthreads();
    if (whole(l, i0)) {
      const uint4* from = reinterpret_cast<const uint4*>(words[buf]);
      uint4* to = reinterpret_cast<uint4*>(q);
#pragma unroll
      for (int u = 0; u < kTile / 16 / kThreads; ++u)
        to[u * kThreads + threadIdx.x] = from[u * kThreads + threadIdx.x];
    }
    l = nl;
    i0 = n0;
#pragma unroll
    for (int u = 0; u < kVec; ++u) cur[u] = nxt[u];
  }
}

// ---------------------------------------------------------------- host

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t describe(const float* const* src, int8_t* const* dst,
                     const int* level_hw, int B, int C, int nchw,
                     Levels* lv) {
  if (B <= 0 || C <= 0) return cudaErrorInvalidValue;
  lv->C = C;
  lv->c_groups = (C + kItemC - 1) / kItemC;
  int64_t tiles = 0, items = 0;
  for (int l = 0; l < kLevels; ++l) {
    const int h = level_hw[2 * l], w = level_hw[2 * l + 1];
    if (h <= 0 || w <= 0 || (int64_t)h * w > INT_MAX)
      return cudaErrorInvalidValue;
    const int hw = h * w;
    lv->src[l] = src[l];
    lv->dst[l] = dst[l];
    lv->hw[l] = hw;
    lv->n[l] = (int64_t)B * hw * C;
    lv->src16[l] = aligned16(src[l]);
    lv->vec[l] = lv->src16[l] && aligned16(dst[l]) &&
                 (!nchw || (hw % 4 == 0 && C % 16 == 0));
    lv->p_items[l] = (hw + kItemP - 1) / kItemP;
    lv->tiles[l] = (int)tiles;
    lv->items[l] = (int)items;
    tiles += (lv->n[l] + kTile - 1) / kTile;
    items += (int64_t)B * lv->c_groups * lv->p_items[l];
    if (tiles > INT_MAX || items > INT_MAX) return cudaErrorInvalidValue;
  }
  lv->tiles[kLevels] = (int)tiles;
  lv->items[kLevels] = (int)items;
  return cudaSuccess;
}

// The blocks of `kernel` the current device holds at once (its SMs x the
// blocks per SM the occupancy API gives), at most `work`; read once per
// kernel and device (the values hold for the process).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, std::atomic<int>* cache, int work,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int resident = dev < kMaxDevices
                     ? cache[dev].load(std::memory_order_acquire)
                     : 0;
  if (resident <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices)
      cache[dev].store(resident, std::memory_order_release);
  }
  *blocks = work < resident ? work : resident;
  return cudaSuccess;
}

std::atomic<int> absmax_grid[kMaxDevices];
std::atomic<int> nchw_grid[kMaxDevices];
std::atomic<int> nhwc_grid[kMaxDevices];

}  // namespace

extern "C" {

// The arguments of the three entry points: src, kLevels device pointers to
// float32 levels of shape [B, H_l, W_l, C]; nchw != 0: each is stored as
// contiguous NCHW [B, C, H_l, W_l] (the NHWC view of an NCHW map), else as
// contiguous NHWC.  level_hw: [h0, w0, ...].  dst: kLevels device pointers
// to contiguous NHWC int8 codes.  amax: kLevels unsigned ints of device
// workspace; scales: kLevels floats on the device.

// Pass 1: zero amax, then the bits of each level's max |f| into it.
int hnd_quantize_levels_absmax(const float* const* src, int8_t* const* dst,
                               const int* level_hw, int B, int C, int nchw,
                               unsigned int* amax, void* stream) {
  Levels lv;
  cudaError_t err = describe(src, dst, level_hw, B, C, nchw, &lv);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  err = persistent_grid(absmax_kernel, absmax_grid, lv.tiles[kLevels],
                        &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(amax, 0, kLevels * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<<<blocks, kThreads, 0, st>>>(lv, amax);
  return (int)cudaGetLastError();
}

// Pass 2: the scales from amax (written to scales) and the codes.
int hnd_quantize_levels_codes(const float* const* src, int8_t* const* dst,
                              const int* level_hw, int B, int C, int nchw,
                              const unsigned int* amax, float* scales,
                              void* stream) {
  Levels lv;
  cudaError_t err = describe(src, dst, level_hw, B, C, nchw, &lv);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  if (nchw) {
    err = persistent_grid(codes_nchw_kernel, nchw_grid, lv.items[kLevels],
                          &blocks);
    if (err != cudaSuccess) return (int)err;
    codes_nchw_kernel<<<blocks, kThreads, 0, st>>>(lv, amax, scales);
  } else {
    err = persistent_grid(codes_nhwc_kernel, nhwc_grid, lv.tiles[kLevels],
                          &blocks);
    if (err != cudaSuccess) return (int)err;
    codes_nhwc_kernel<<<blocks, kThreads, 0, st>>>(lv, amax, scales);
  }
  return (int)cudaGetLastError();
}

// Both passes.
int hnd_quantize_levels(const float* const* src, int8_t* const* dst,
                        const int* level_hw, int B, int C, int nchw,
                        unsigned int* amax, float* scales, void* stream) {
  const int err = hnd_quantize_levels_absmax(src, dst, level_hw, B, C, nchw,
                                             amax, stream);
  if (err != 0) return err;
  return hnd_quantize_levels_codes(src, dst, level_hw, B, C, nchw, amax,
                                   scales, stream);
}

}  // extern "C"
