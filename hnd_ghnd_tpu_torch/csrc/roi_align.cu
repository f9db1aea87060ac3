// Multi-level RoIAlign (torchvision 0.4.2 semantics) for sm_90a: the forward
// on float32, bfloat16 or int8 levels, and its backward with respect to the
// levels.
//
// Forward: replaces hnd_ghnd_tpu/ops/pallas_roi.py:
// pallas_multiscale_roi_align_batch (_roi_kernel with its _prep), f32, bf16
// and int8 tables (table_scale, pallas_roi.py:208-209, 373-377).  The TPU
// kernel's window-DMA classes, 8-row snapping and MXU y-contraction exist
// because of Mosaic's limits and are not carried over.
// Backward: replaces the backward of pallas_roi.py:_make_vjp_pool, which is
// jax.linear_transpose of the XLA gather program (a scatter-add), not a
// Pallas kernel.
//
// What bounds them on the H100.  At the serving shapes (B=8, 1000 RoIs per
// image, 7x7 bins, 2x2 samples, C=256) every bin reads 16 corner rows of C
// channels: 8000 * 49 * 16 rows = 6.4 GB of f32 row reads (1.6 GB on int8
// tables), against the ~0.3 GB of f32 level cells (~74 MB of int8 codes) the
// RoIs tap and the 400 MB output that bound the kernel by HBM bytes. The
// P2-P5 maps of one 832x1344 image are ~95 MB in float32 (P2 alone 208 * 336
// * 256 * 4 = 71.6 MB), ~48 MB in bfloat16 and ~24 MB in int8, so only the
// int8 tables of one image fit the 50 MB L2; the row reads are served by L1
// (neighbouring samples of one RoI share corners) and L2.  The design before
// this one recomputed each sample's geometry (six IEEE divisions) for every
// output element and read one scalar channel per thread per tap: bound by its
// own instructions, it took 1.95 ms on f32 and 1.97 ms on int8 tables.  This
// one takes 0.63 ms on f32 tables (chip_roi_ab.py on an H100 80GB HBM3 at
// 700 W, the wrapper's call on the card, level assignment included;
// PERF.md), about 3x the bound of the cells it taps: the row stream through
// L1 and L2 (6.4 GB in 0.63 ms) sets the pace.  On int8 tables it takes 0.42
// ms for a quarter of the row bytes: there the arithmetic per tap and channel
// (a byte permute, a subtract, a multiply and an add) weighs as much as the
// rows.  The train step's forward (2 x 512 RoIs on bf16 levels) is the same
// loop at an eighth of the RoIs.  The backward adds each tap with float
// atomics into a float32 workspace the size of P2-P5: its 0.40 ms on bf16
// levels are ~0.24 ms of atomics in L2, 0.06 ms of zeroing the 190 MB
// workspace and 0.10 ms of rounding it to bf16, passes that no scatter into a
// float32 sum can skip.
//
// Design.  One block per RoI, or per band of its bin rows when the RoIs are
// too few to fill the card (rows_for).  The block first computes the RoI's
// axis samples (lo, hi, w_lo*ok, w_hi*ok) once, then for each of its bins the
// weight and the level cell of each of the 4*S*S taps, in the order the sum
// runs, into shared memory (taps_for): a whole RoI at P=14, S=2 takes 14 x 14
// bins x 16 taps x 8 bytes = 25 KB.  Then each thread owns a vector of V
// channels of one bin, 16 bytes of the levels' type where C and the pointers
// allow it (4 f32, 8 bf16 or 16 int8 channels; else 8 or 4 bytes, else one
// element: the caller picks V, roi_align_kernels.vector_width), and does per
// tap one vector load of the corner row's slice, a multiply and an add per
// channel: no geometry, no division, no index arithmetic beyond one
// multiply-add per tap.  int8 codes become floats by a byte permute and a
// subtract (flipped_byte_to_float), not by the conversion unit.  Consecutive
// threads take consecutive vectors of one bin, so a corner row is one
// coalesced segment and the block's bins walk the RoI's rows through L1.  The
// finished bin goes out in 16-byte stores (four float4 for the int8 path's 16
// f32 channels).  The backward runs the same grid and tap tables, with each
// bin's taps on one cell merged (merge_taps): each thread loads 4 channels of
// its bin's cotangent and adds them, times each tap's weight, with one float4
// atomicAdd, which compute capability 9.x has for global memory (a quarter of
// the f32 atomic instructions of one channel per thread; at 8 channels per
// thread the lanes of a warp's atomic would lie 32 bytes apart and touch
// twice the sectors, roi_align_kernels.backward_width).  The rounding pass
// reads 8 floats and writes one 16-byte vector of bf16.
//
// Arithmetic follows hnd_ghnd_tpu/ops/roi_align.py:_roi_align_flat (the XLA
// path) operation for operation, with __fmul_rn/__fadd_rn so nvcc cannot
// contract a multiply-add into an FMA: sample points are
// y1 + bin*bin_h + samp*bin_h, the border rules are those of
// _bilinear_params, and each channel's bin sum runs in the same order
// (sample y, sample x, corner y, corner x) with the weight
// ((wy*oky) * (wx*okx)) * (1/s^2), all in float32; vectors run across
// channels and change no channel's order.  bf16 levels are read as bf16,
// converted exactly to float, and the finished bin is rounded once (round
// to nearest even), as the plain version's float32 program followed by one
// cast.  The JAX kernels round the weights to bf16 for the MXU; the weights
// here stay float32.  int8 levels are converted exactly to float and the
// level's dequant scale (a device array, written by the level quantizer of
// fpn_quant.cu, so the host never reads it) folds into the sample-mean
// factor once per RoI: inv_count * scale[lvl], exact because inv_count is a
// power of two, so the weight is ((wy*oky) * (wx*okx)) * (inv_count*scale)
// as in the plain version; the output is float32.  The finished bin is
// multiplied by the RoI's validity weight.  The per-RoI FPN level comes
// from the caller (computed with the same torch ops as the plain version)
// so an ulp of log2/sqrt on the device cannot move a RoI to another level.
// The backward multiplies (g * valid) * weight per tap as the plain
// autograd does, but the taps of a bin on one cell add once, with their
// summed weight (g*(w_u + w_t) where the plain autograd adds g*w_u + g*w_t:
// another rounding, within the backward's tolerance).  A tap of weight 0
// adds nothing to a finite cotangent and is skipped then; under a NaN or
// infinite cotangent it adds its product, g * 0 = NaN, to its clamped cell,
// as the plain autograd does (a RoI whose samples all fall off its level
// spreads NaN there).  A tap merged into an earlier one on its cell keeps
// that rule: it is marked +0 when it or the taps before it on that cell
// weigh 0 (the plain sum on the cell is NaN then) and -0 otherwise (the
// merged product, +-inf, is the plain sum), and a -0 tap is always
// skipped.  The atomics add in an order that changes from run to run (as
// torchvision's CUDA roi_align backward does), so the result is not
// bit-repeatable.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// P2-P5: the caller's level indices are 0..3
constexpr int kLevels = 4;
// the forward's level types (hnd_roi_align_fwd's dtype)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kS8 = 2;
// 128 threads a block: more, smaller blocks resident on an SM, so that one
// block's tap tables are built while another's loads are in flight
constexpr int kThreads = 128;
// blocks that fill the card once: 132 SMs with 16 resident blocks each
constexpr int64_t kFullWave = 132 * 16;
// the shared memory a block of sm_90 may use, and what it may use without
// opting in
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Levels {
  const void* ptr[kLevels];  // [B, H_l, W_l, C] contiguous, f32, bf16 or s8
  int h[kLevels];
  int w[kLevels];
  float scale[kLevels];
};

struct GradLevels {
  float* ptr[kLevels];  // [B, H_l, W_l, C] contiguous f32, zeroed
  int h[kLevels];
  int w[kLevels];
  float scale[kLevels];
};

struct AxisSample {
  int lo, hi;
  float w_lo, w_hi;  // already multiplied by the in-range flag
};

// N elements of E as one load or store of N * sizeof(E) bytes
template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E v[N];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ void convert(float& d, float v) { d = v; }
__device__ __forceinline__ void convert(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

// Byte b of a word of int8 codes whose sign bits are flipped (code + 128,
// 1..255), as the float code: the byte becomes the low mantissa byte of
// 2^23 and 2^23 + 128 is subtracted, exact for every code.  A byte permute
// and an add run at 64 and 128 results per clock on an SM of sm_90, the
// int-to-float conversion unit at 16, which bounded the int8 forward.
__device__ __forceinline__ float flipped_byte_to_float(uint32_t word, int b) {
  return __fsub_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7540u + b)),
                   8388736.0f);
}

// V channels of the levels' type from p, as floats
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (std::is_same<T, int8_t>::value && V >= 4) {
    const Pack<uint32_t, V / 4> x =
        *reinterpret_cast<const Pack<uint32_t, V / 4>*>(p);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const uint32_t word = x.v[k] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) v[4 * k + b] = flipped_byte_to_float(word, b);
    }
  } else {
    const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_float(x.v[j]);
  }
}

// out[j] = O(acc[j] * valid), in stores of at most 16 bytes
template <typename O, int V>
__device__ __forceinline__ void store_vec(O* __restrict__ p, const float* acc,
                                          float valid) {
  constexpr int kPiece = V * sizeof(O) > 16 ? 16 / sizeof(O) : V;
#pragma unroll
  for (int k = 0; k < V; k += kPiece) {
    Pack<O, kPiece> x;
#pragma unroll
    for (int j = 0; j < kPiece; ++j)
      convert(x.v[j], __fmul_rn(acc[k + j], valid));
    *reinterpret_cast<Pack<O, kPiece>*>(p + k) = x;
  }
}

// p[j] += g[j] * w, with float4, float2 or float atomics (global memory)
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* p, const float* g,
                                               float w) {
#pragma unroll
  for (int k = 0; k < V; k += (V >= 4 ? 4 : V)) {
    if constexpr (V >= 4) {
      atomicAdd(reinterpret_cast<float4*>(p + k),
                make_float4(__fmul_rn(g[k], w), __fmul_rn(g[k + 1], w),
                            __fmul_rn(g[k + 2], w), __fmul_rn(g[k + 3], w)));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(p + k),
                make_float2(__fmul_rn(g[k], w), __fmul_rn(g[k + 1], w)));
    } else {
      atomicAdd(p + k, __fmul_rn(g[k], w));
    }
  }
}

// _bilinear_params for one coordinate on an axis of `size` cells.
__device__ __forceinline__ AxisSample axis_sample(float coord, float size) {
  const float ok = (coord >= -1.0f && coord <= size) ? 1.0f : 0.0f;
  float c = fmaxf(coord, 0.0f);
  float low = floorf(c);
  const bool snap = low >= __fsub_rn(size, 1.0f);
  if (snap) {
    low = __fsub_rn(size, 1.0f);
    c = low;
  }
  const float high = snap ? low : __fadd_rn(low, 1.0f);
  const float frac = __fsub_rn(c, low);
  AxisSample a;
  a.lo = (int)low;
  a.hi = (int)high;
  a.w_lo = __fmul_rn(__fsub_rn(1.0f, frac), ok);
  a.w_hi = __fmul_rn(frac, ok);
  return a;
}

// coord = start + bin*bin_size + samp*bin_size, evaluated left to right;
// samp = (s + 0.5) / S
__device__ __forceinline__ float sample_coord(float start, int bin, int s,
                                              int S, float bin_size) {
  const float samp = __fdiv_rn((float)s + 0.5f, (float)S);
  return __fadd_rn(__fadd_rn(start, __fmul_rn((float)bin, bin_size)),
                   __fmul_rn(samp, bin_size));
}

// The RoI's box on its level: start corner, bin sizes and the level's size.
struct RoiGeom {
  float x1, y1, bin_w, bin_h, fh, fw;
  int H, W;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* __restrict__ boxes,
                                            int m, float scale, int H, int W,
                                            int P) {
  RoiGeom g;
  g.x1 = __fmul_rn(boxes[4 * m + 0], scale);
  g.y1 = __fmul_rn(boxes[4 * m + 1], scale);
  const float x2 = __fmul_rn(boxes[4 * m + 2], scale);
  const float y2 = __fmul_rn(boxes[4 * m + 3], scale);
  const float roi_w = fmaxf(__fsub_rn(x2, g.x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(y2, g.y1), 1.0f);
  g.bin_w = __fdiv_rn(roi_w, (float)P);
  g.bin_h = __fdiv_rn(roi_h, (float)P);
  g.H = H;
  g.W = W;
  g.fh = (float)H;
  g.fw = (float)W;
  return g;
}

// The block's share of a RoI: bin rows [row0, row0 + rows) of P, `rows_max`
// rows for every block of the grid.  Shared memory holds, for each of its
// bins, the 4*S*S taps in the order of the sum (sample y, sample x, corner
// y, corner x): weights w, level cells y*W + x; then the axis samples.
struct Taps {
  float* w;
  int* cell;
  int nt;  // taps per bin
};

__host__ __device__ inline size_t taps_smem(int rows_max, int P, int S) {
  return (size_t)rows_max * P * 4 * S * S * (sizeof(float) + sizeof(int)) +
         (size_t)(rows_max + P) * S * sizeof(AxisSample);
}

// Fill the block's tap tables; inv: the sample-mean factor (times the
// level's dequant scale for int8 tables).  Ends with a block barrier.
__device__ Taps taps_for(const RoiGeom& g, int row0, int rows, int rows_max,
                         int P, int S, float inv) {
  extern __shared__ float4 smem[];
  const int nt = 4 * S * S;
  float* w = reinterpret_cast<float*>(smem);
  int* cell = reinterpret_cast<int*>(w + (size_t)rows_max * P * nt);
  AxisSample* ay =
      reinterpret_cast<AxisSample*>(cell + (size_t)rows_max * P * nt);
  AxisSample* ax = ay + rows_max * S;
  for (int i = threadIdx.x; i < (rows + P) * S; i += blockDim.x) {
    if (i < rows * S)
      ay[i] = axis_sample(sample_coord(g.y1, row0 + i / S, i % S, S, g.bin_h),
                          g.fh);
    else {
      const int j = i - rows * S;
      ax[j] = axis_sample(sample_coord(g.x1, j / S, j % S, S, g.bin_w), g.fw);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * P * nt; i += blockDim.x) {
    const int bin = i / nt, t = i - bin * nt;
    const int s = t >> 2;
    const AxisSample a = ay[(bin / P) * S + s / S];
    const AxisSample b = ax[(bin % P) * S + s % S];
    const bool cy = t & 2, cx = t & 1;
    w[i] = __fmul_rn(__fmul_rn(cy ? a.w_hi : a.w_lo, cx ? b.w_hi : b.w_lo),
                     inv);
    cell[i] = (cy ? a.hi : a.lo) * g.W + (cx ? b.hi : b.lo);
  }
  __syncthreads();
  return Taps{w, cell, nt};
}

// The backward's tap tables: each bin's taps on one cell summed, in tap
// order, into the first of them, and the others' weights zeroed: +0 when
// the tap or the sum before it weighs 0, else -0 (see the header: a
// non-finite cotangent adds NaN through a +0 tap, never through a -0 one).
// Neighbouring samples share corners and a bin under a cell wide has its
// samples in one or two cells, so this saves atomics, the backward's
// bound.  Ends with a block barrier.
__device__ void merge_taps(const Taps& taps, int bins) {
  for (int bin = threadIdx.x; bin < bins; bin += blockDim.x) {
    float* w = taps.w + bin * taps.nt;
    const int* cell = taps.cell + bin * taps.nt;
    for (int t = 1; t < taps.nt; ++t)
      for (int u = 0; u < t; ++u)
        if (cell[u] == cell[t]) {
          const bool zero = w[u] == 0.0f || w[t] == 0.0f;
          w[u] = __fadd_rn(w[u], w[t]);
          w[t] = zero ? 0.0f : -0.0f;
          break;
        }
  }
  __syncthreads();
}

// T: the levels' type; O: the output's (T, or float for int8 levels); V:
// channels per thread.  table_scale: [kLevels] dequant scales on the device
// (int8), else null.
template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(Levels levels, const float* __restrict__ boxes,
                         const int* __restrict__ box_level,
                         const float* __restrict__ box_weight,
                         const float* __restrict__ table_scale,
                         O* __restrict__ out, int n_per_image, int C, int P,
                         int S, int rows_max, float inv_count) {
  const int bands = (P + rows_max - 1) / rows_max;
  const int m = blockIdx.x / bands;
  const int row0 = (blockIdx.x % bands) * rows_max;
  const int rows = min(rows_max, P - row0);
  const int lvl = box_level[m];
  const RoiGeom g = roi_geom(boxes, m, levels.scale[lvl], levels.h[lvl],
                             levels.w[lvl], P);
  const float inv = table_scale == nullptr
                        ? inv_count
                        : __fmul_rn(inv_count, table_scale[lvl]);
  const Taps taps = taps_for(g, row0, rows, rows_max, P, S, inv);
  // the box's validity weight multiplies the finished bin, as
  // `out * boxes_valid` does in the plain version
  const float valid = box_weight == nullptr ? 1.0f : box_weight[m];
  const T* __restrict__ feat = static_cast<const T*>(levels.ptr[lvl]) +
                               (int64_t)(m / n_per_image) * g.H * g.W * C;
  O* __restrict__ out_band = out + ((int64_t)m * P + row0) * P * C;
  const int vecs = C / V;
  for (int i = threadIdx.x; i < rows * P * vecs; i += blockDim.x) {
    const int bin = i / vecs;
    const int c = (i - bin * vecs) * V;
    const float* w = taps.w + bin * taps.nt;
    const int* cell = taps.cell + bin * taps.nt;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < taps.nt; t += 4) {
      // one sample's four corners
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[V];
        load_vec<T, V>(feat + (int64_t)cell[t + k] * C + c, v);
        const float wt = w[t + k];
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wt));
      }
    }
    store_vec<O, V>(out_band + (int64_t)bin * C + c, acc, valid);
  }
}

// T: the cotangent's type; V: channels per thread.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(GradLevels grads, const float* __restrict__ boxes,
                         const int* __restrict__ box_level,
                         const float* __restrict__ box_weight,
                         const T* __restrict__ grad_out, int n_per_image,
                         int C, int P, int S, int rows_max, float inv_count) {
  const int bands = (P + rows_max - 1) / rows_max;
  const int m = blockIdx.x / bands;
  const int row0 = (blockIdx.x % bands) * rows_max;
  const int rows = min(rows_max, P - row0);
  const int lvl = box_level[m];
  const RoiGeom g = roi_geom(boxes, m, grads.scale[lvl], grads.h[lvl],
                             grads.w[lvl], P);
  const Taps taps = taps_for(g, row0, rows, rows_max, P, S, inv_count);
  merge_taps(taps, rows * P);
  const float valid = box_weight == nullptr ? 1.0f : box_weight[m];
  float* __restrict__ dfeat =
      grads.ptr[lvl] + (int64_t)(m / n_per_image) * g.H * g.W * C;
  const T* __restrict__ g_band = grad_out + ((int64_t)m * P + row0) * P * C;
  const int vecs = C / V;
  for (int i = threadIdx.x; i < rows * P * vecs; i += blockDim.x) {
    const int bin = i / vecs;
    const int c = (i - bin * vecs) * V;
    const float* w = taps.w + bin * taps.nt;
    const int* cell = taps.cell + bin * taps.nt;
    // (g * valid) * weight per tap as the plain autograd multiplies, with
    // the merged taps' summed weight; taps of weight 0 are skipped while
    // the cotangent is finite, and +0 taps add g * 0 = NaN when it is not
    float gv[V];
    load_vec<T, V>(g_band + (int64_t)bin * C + c, gv);
    bool finite = true;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gv[j] = __fmul_rn(gv[j], valid);
      finite = finite && isfinite(gv[j]);
    }
#pragma unroll 4
    for (int t = 0; t < taps.nt; ++t)
      if (w[t] != 0.0f || (!finite && !signbit(w[t])))
        atomic_add_vec<V>(dfeat + (int64_t)cell[t] * C + c, gv, w[t]);
  }
}

// dst[i] = bf16(src[i]), 8 floats in and one 16-byte store out per step;
// the tail of n % 8 one by one.  src and dst 16-byte aligned.
__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n / 8; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
    const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    Pack<__nv_bfloat16, 8> o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.v[j] = __float2bfloat16_rn(f[j]);
    reinterpret_cast<Pack<__nv_bfloat16, 8>*>(dst)[i] = o;
  }
  for (int64_t i = n / 8 * 8 + first; i < n; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

bool bad_sizes(int64_t M, int n_per_image, int C, int P, int S) {
  return M <= 0 || n_per_image <= 0 || C <= 0 || P <= 0 || S <= 0 ||
         M * P > 0x7fffffffLL;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// V channels of T per thread: a width of 16, 8 or 4 bytes, or one element,
// that divides C.  The pointers read as T must be aligned to V*sizeof(T),
// those written as float or O to the pieces of at most 16 bytes they are
// written in (piece).
bool bad_width(int V, size_t t_size, int C) {
  const size_t bytes = (size_t)V * t_size;
  return V <= 0 || C % V != 0 ||
         !(bytes == 16 || bytes == 8 || bytes == 4 || V == 1);
}

size_t piece(int V, size_t o_size) {
  return V * o_size < 16 ? V * o_size : 16;
}

// Bin rows per block: all P, halved while the RoIs' blocks do not fill the
// card once.
int rows_for(int64_t M, int P) {
  int rows = P;
  while (rows > 1 && M * ((P + rows - 1) / rows) < kFullWave)
    rows = (rows + 1) / 2;
  return rows;
}

template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int64_t blocks, size_t smem,
           cudaStream_t s, Args... args) {
  if (smem > kMaxSmem || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, typename O, typename... Args>
int launch_fwd(int V, int64_t blocks, size_t smem, cudaStream_t s,
               Args... args) {
  constexpr int v16 = 16 / sizeof(T), v8 = 8 / sizeof(T), v4 = 4 / sizeof(T);
  if (V == v16)
    return launch(roi_align_fwd_kernel<T, O, v16>, blocks, smem, s, args...);
  if (V == v8)
    return launch(roi_align_fwd_kernel<T, O, v8>, blocks, smem, s, args...);
  if (V == v4)
    return launch(roi_align_fwd_kernel<T, O, v4>, blocks, smem, s, args...);
  if (V == 1)
    return launch(roi_align_fwd_kernel<T, O, 1>, blocks, smem, s, args...);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename... Args>
int launch_bwd(int V, int64_t blocks, size_t smem, cudaStream_t s,
               Args... args) {
  constexpr int v16 = 16 / sizeof(T), v8 = 8 / sizeof(T), v4 = 4 / sizeof(T);
  if (V == v16)
    return launch(roi_align_bwd_kernel<T, v16>, blocks, smem, s, args...);
  if (V == v8)
    return launch(roi_align_bwd_kernel<T, v8>, blocks, smem, s, args...);
  if (V == v4)
    return launch(roi_align_bwd_kernel<T, v4>, blocks, smem, s, args...);
  if (V == 1)
    return launch(roi_align_bwd_kernel<T, 1>, blocks, smem, s, args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// level_ptrs: kLevels device pointers; level_hw: [h0, w0, h1, w1, ...];
// level_scales: kLevels floats (host arrays, copied into the launch).
// boxes [M, 4] f32, box_level [M] i32, box_weight [M] f32 or null;
// dtype: kF32, kBF16 or kS8, the levels' type; table_scale: kLevels f32
// dequant scales on the device for kS8, else null; out [M, P, P, C] in the
// levels' type, float32 for kS8.  RoI m belongs to image m / n_per_image.
// vec: channels per thread (roi_align_kernels.vector_width); the levels
// aligned to vec elements, out to its pieces of at most 16 bytes.
int hnd_roi_align_fwd(const void* const* level_ptrs, const int* level_hw,
                      const float* level_scales, const float* boxes,
                      const int* box_level, const float* box_weight,
                      const float* table_scale, void* out, int64_t M,
                      int n_per_image, int C, int P, int sampling_ratio,
                      int dtype, int vec, void* stream) {
  const size_t t_size = dtype == kBF16 ? 2 : dtype == kS8 ? 1 : 4;
  const size_t o_size = dtype == kS8 ? 4 : t_size;
  if (bad_sizes(M, n_per_image, C, P, sampling_ratio) ||
      (dtype != kF32 && dtype != kBF16 && dtype != kS8) ||
      (dtype == kS8) != (table_scale != nullptr) ||
      bad_width(vec, t_size, C) || !aligned(out, piece(vec, o_size)))
    return (int)cudaErrorInvalidValue;
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    if (!aligned(level_ptrs[l], vec * t_size))
      return (int)cudaErrorInvalidValue;
    levels.ptr[l] = level_ptrs[l];
    levels.h[l] = level_hw[2 * l];
    levels.w[l] = level_hw[2 * l + 1];
    levels.scale[l] = level_scales[l];
  }
  const float inv_count = 1.0f / (float)(sampling_ratio * sampling_ratio);
  const int rows = rows_for(M, P);
  const int64_t blocks = M * ((P + rows - 1) / rows);
  const size_t smem = taps_smem(rows, P, sampling_ratio);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        vec, blocks, smem, s, levels, boxes, box_level, box_weight,
        (const float*)nullptr, static_cast<__nv_bfloat16*>(out), n_per_image,
        C, P, sampling_ratio, rows, inv_count);
  if (dtype == kS8)
    return launch_fwd<int8_t, float>(
        vec, blocks, smem, s, levels, boxes, box_level, box_weight,
        table_scale, static_cast<float*>(out), n_per_image, C, P,
        sampling_ratio, rows, inv_count);
  return launch_fwd<float, float>(
      vec, blocks, smem, s, levels, boxes, box_level, box_weight,
      (const float*)nullptr, static_cast<float*>(out), n_per_image, C, P,
      sampling_ratio, rows, inv_count);
}

// grad_ptrs: kLevels device pointers to zeroed f32 [B, H_l, W_l, C] buffers
// that the cotangent is added into; grad_out [M, P, P, C] (bf16 != 0:
// bfloat16, else f32); vec: channels per thread, grad_out aligned to vec
// elements and the buffers to the atomics' pieces of at most 16 bytes; the
// other arguments as for hnd_roi_align_fwd.
int hnd_roi_align_bwd(float* const* grad_ptrs, const int* level_hw,
                      const float* level_scales, const float* boxes,
                      const int* box_level, const float* box_weight,
                      const void* grad_out, int64_t M, int n_per_image, int C,
                      int P, int sampling_ratio, int bf16, int vec,
                      void* stream) {
  const size_t t_size = bf16 ? 2 : 4;
  if (bad_sizes(M, n_per_image, C, P, sampling_ratio) ||
      bad_width(vec, t_size, C) || !aligned(grad_out, vec * t_size))
    return (int)cudaErrorInvalidValue;
  GradLevels grads;
  for (int l = 0; l < kLevels; ++l) {
    if (!aligned(grad_ptrs[l], piece(vec, 4)))
      return (int)cudaErrorInvalidValue;
    grads.ptr[l] = grad_ptrs[l];
    grads.h[l] = level_hw[2 * l];
    grads.w[l] = level_hw[2 * l + 1];
    grads.scale[l] = level_scales[l];
  }
  const float inv_count = 1.0f / (float)(sampling_ratio * sampling_ratio);
  const int rows = rows_for(M, P);
  const int64_t blocks = M * ((P + rows - 1) / rows);
  const size_t smem = taps_smem(rows, P, sampling_ratio);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(
        vec, blocks, smem, s, grads, boxes, box_level, box_weight,
        static_cast<const __nv_bfloat16*>(grad_out), n_per_image, C, P,
        sampling_ratio, rows, inv_count);
  return launch_bwd<float>(vec, blocks, smem, s, grads, boxes, box_level,
                           box_weight, static_cast<const float*>(grad_out),
                           n_per_image, C, P, sampling_ratio, rows,
                           inv_count);
}

// dst[i] = bf16(src[i]), round to nearest even: the backward's second pass.
// src and dst 16-byte aligned.
int hnd_f32_to_bf16(const float* src, void* dst, int64_t n, void* stream) {
  if (n <= 0 || !aligned(src, 16) || !aligned(dst, 16))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t want = (n / 8 + threads) / threads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  f32_to_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<__nv_bfloat16*>(dst), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
