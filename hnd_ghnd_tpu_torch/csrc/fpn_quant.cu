// Symmetric per-level int8 quantization of the FPN levels P2-P5 for sm_90a:
// the tables an eval with int8_roi_pool pools from.
//
// Replaces hnd_ghnd_tpu/ops/roi_align.py:quantize_fpn_levels (XLA ops, not
// a Pallas kernel; it feeds the int8 tables of pallas_roi.py:_roi_kernel).
// Per level l over the whole batch: s_l = max|f| / 127 (1 where that max is
// 0), q = clamp(round-half-even(f / s_l), -127, 127).
//
// Bound on the H100: bytes.  At B=8 on the 832x1344 bucket the four levels
// are 8 x 92,820 rows of C=256 float32, 760 MB read once for the abs-max and
// once for the codes, 190 MB of codes written: 1.7 GB of traffic against
// the 950 MB a single pass would move (the abs-max must finish before the
// first code, and the levels do not fit in the 50 MB L2).
//
// Two launches on one stream, the scales never leaving the device:
//   1. the abs-max of every level: grid-stride loops with 16-byte loads,
//      a warp-shuffle and shared-memory block reduction, then one atomicMax
//      per block on the float's bits (non-negative floats order as their
//      unsigned bits), so the result is exact in any order;
//   2. the codes, each block of level l deriving s_l from the abs-max
//      (block (0, l) writes it out).  The levels arrive either as
//      contiguous NHWC or as the NHWC view of contiguous NCHW maps, which
//      the FPN produces: the second case goes through a 32 x 32 shared-memory
//      tile per (image, channel block, pixel block), read along pixels and
//      written along channels, so the float32 NHWC copy of the maps is never
//      made.  Codes are always written as contiguous NHWC int8.
//
// Bit-exactness with ops/roi_align.py:quantize_fpn_levels: divisions are
// IEEE round-to-nearest (__fdiv_rn), rounding is rintf (half to even), and
// the abs-max ignores nothing (bucket padding is zeros and counts).  Build
// without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 4;
constexpr int kThreads = 256;
constexpr int kTile = 32;

struct QuantLevels {
  const float* src[kLevels];  // NHWC contiguous, or NCHW contiguous
  int8_t* dst[kLevels];       // NHWC contiguous
  int64_t n[kLevels];         // B * H_l * W_l * C
  int hw[kLevels];            // H_l * W_l
  int64_t tile_start[kLevels + 1];  // NCHW: first tile of each level
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max of v; valid in thread 0.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float s_max[32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_max[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  if (warp == 0) v = warp_max(lane < n_warps ? s_max[lane] : 0.0f);
  return v;
}

// blockIdx.y = level
__global__ void absmax_kernel(QuantLevels lv, unsigned int* __restrict__ amax) {
  const int l = blockIdx.y;
  const float* __restrict__ x = lv.src[l];
  const int64_t n = lv.n[l];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      m = fmaxf(fmaxf(m, fabsf(v.x)),
                fmaxf(fabsf(v.y), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));
  } else {
    for (int64_t i = tid; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + l, __float_as_uint(m));
}

__device__ __forceinline__ float level_scale(const unsigned int* amax, int l) {
  const float a = __uint_as_float(amax[l]);
  return a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
}

__device__ __forceinline__ int8_t code(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

// NHWC source: elementwise over each level; blockIdx.y = level.
__global__ void codes_nhwc_kernel(QuantLevels lv,
                                  const unsigned int* __restrict__ amax,
                                  float* __restrict__ scales) {
  const int l = blockIdx.y;
  const float s = level_scale(amax, l);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[l] = s;
  const float* __restrict__ x = lv.src[l];
  int8_t* __restrict__ q = lv.dst[l];
  const int64_t n = lv.n[l];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(code(v.x, s), code(v.y, s), code(v.z, s),
                         code(v.w, s));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride) q[i] = code(x[i], s);
  } else {
    for (int64_t i = tid; i < n; i += stride) q[i] = code(x[i], s);
  }
}

// NCHW source, NHWC codes: one 32 x 32 (channel x pixel) tile per block,
// blocks numbered across the levels by tile_start; block (32, 8).
__global__ void codes_nchw_kernel(QuantLevels lv, int C,
                                  const unsigned int* __restrict__ amax,
                                  float* __restrict__ scales) {
  __shared__ int8_t tile[kTile][kTile + 4];
  const int64_t t = blockIdx.x;
  int l = 0;
  while (l + 1 < kLevels && t >= lv.tile_start[l + 1]) ++l;
  const float s = level_scale(amax, l);
  if (t == lv.tile_start[l] && threadIdx.x == 0 && threadIdx.y == 0)
    scales[l] = s;
  const int hw = lv.hw[l];
  const int p_tiles = (hw + kTile - 1) / kTile;
  const int c_tiles = (C + kTile - 1) / kTile;
  int64_t r = t - lv.tile_start[l];
  const int pt = (int)(r % p_tiles);
  r /= p_tiles;
  const int ct = (int)(r % c_tiles);
  const int64_t img = r / c_tiles;
  const int p0 = pt * kTile;
  const int c0 = ct * kTile;
  const float* __restrict__ x = lv.src[l] + img * C * (int64_t)hw;
  int8_t* __restrict__ q = lv.dst[l] + img * C * (int64_t)hw;
  // read along pixels (coalesced in NCHW)
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int c = c0 + j;
    const int p = p0 + threadIdx.x;
    if (c < C && p < hw) tile[j][threadIdx.x] = code(x[(int64_t)c * hw + p], s);
  }
  __syncthreads();
  // write along channels (coalesced in NHWC)
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int p = p0 + j;
    const int c = c0 + threadIdx.x;
    if (c < C && p < hw) q[(int64_t)p * C + c] = tile[threadIdx.x][j];
  }
}

unsigned grid_for(int64_t n) {
  // one float4 per thread, at most 8 blocks per SM for each level
  const int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > 8 * 132 ? 8 * 132 : blocks));
}

}  // namespace

extern "C" {

// src: kLevels device pointers to float32 levels of shape [B, H_l, W_l, C];
// nchw != 0: each is stored as contiguous NCHW [B, C, H_l, W_l] (the NHWC
// view of an NCHW map), else as contiguous NHWC.  level_hw: [h0, w0, ...].
// dst: kLevels device pointers to contiguous NHWC int8 codes.  amax: kLevels
// unsigned ints of device workspace (zeroed here); scales: kLevels floats
// on the device, written.
int hnd_quantize_levels(const float* const* src, int8_t* const* dst,
                        const int* level_hw, int B, int C, int nchw,
                        unsigned int* amax, float* scales, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QuantLevels lv;
  int64_t largest = 0;
  lv.tile_start[0] = 0;
  for (int l = 0; l < kLevels; ++l) {
    const int h = level_hw[2 * l], w = level_hw[2 * l + 1];
    if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
    lv.src[l] = src[l];
    lv.dst[l] = dst[l];
    lv.hw[l] = h * w;
    lv.n[l] = (int64_t)B * h * w * C;
    largest = lv.n[l] > largest ? lv.n[l] : largest;
    lv.tile_start[l + 1] = lv.tile_start[l] + (int64_t)B *
                           ((C + kTile - 1) / kTile) *
                           ((h * w + kTile - 1) / kTile);
  }
  cudaError_t err = cudaMemsetAsync(amax, 0, kLevels * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_for(largest), kLevels);
  absmax_kernel<<<grid, kThreads, 0, st>>>(lv, amax);
  if (nchw) {
    if (lv.tile_start[kLevels] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    codes_nchw_kernel<<<(unsigned)lv.tile_start[kLevels], dim3(kTile, 8), 0,
                        st>>>(lv, C, amax, scales);
  } else {
    codes_nhwc_kernel<<<grid, kThreads, 0, st>>>(lv, amax, scales);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
