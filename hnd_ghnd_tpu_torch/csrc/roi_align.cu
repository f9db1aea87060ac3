// Multi-level RoIAlign (torchvision 0.4.2 semantics) for sm_90a: the forward
// on float32, bfloat16 or int8 levels, and its backward with respect to the
// levels.
//
// Forward: replaces hnd_ghnd_tpu/ops/pallas_roi.py:
// pallas_multiscale_roi_align_batch (_roi_kernel with its _prep), f32, bf16
// and int8 tables (table_scale, pallas_roi.py:208-209, 373-377).  The TPU kernel's window-DMA classes, 8-row snapping and MXU
// y-contraction exist because of Mosaic's limits and are not carried over.
// Backward: replaces the backward of pallas_roi.py:_make_vjp_pool, which is
// jax.linear_transpose of the XLA gather program (a scatter-add), not a
// Pallas kernel.
//
// Bound on the H100: bytes.  At the serving shapes (B=8, 1000 RoIs per
// image, 7x7 bins, 2x2 samples, C=256 f32) every sample reads 4 corner rows
// of 1 KB: 8000 * 196 * 4 * 1 KB = 6.4 GB of loads, largely served from the
// 50 MB L2 because neighbouring samples share corners and the P2-P5 maps of
// one image are ~32 MB.  The output is 8000 * 49 KB = 400 MB.  The train
// step's forward (2 x 512 RoIs on bf16 levels) reads half the bytes per row,
// and the int8 tables of an eval with int8_roi_pool a quarter.
//
// Forward design: one block per (RoI, output row); threads walk the
// channels, so the four corner rows of each sample are read as contiguous
// NHWC rows (one coalesced segment per warp) and the bin is written straight
// to out[m, py, px, :].  The per-sample geometry is uniform across the block
// and recomputed by every thread (a few dozen flops against the loads).
//
// Arithmetic follows hnd_ghnd_tpu/ops/roi_align.py:_roi_align_flat (the XLA
// path) operation for operation, with __fmul_rn/__fadd_rn so nvcc cannot
// contract a multiply-add into an FMA: sample points are
// y1 + bin*bin_h + samp*bin_h, the border rules are those of
// _bilinear_params, and the bin sum runs in the same order
// (sample y, sample x, corner y, corner x) with the weight
// ((wy*oky) * (wx*okx)) * (1/s^2), all in float32.  bf16 levels are read as
// bf16, converted exactly to float, and the finished bin is rounded once
// (round to nearest even), as the plain version's float32 program followed
// by one cast.  The JAX kernels round the weights to bf16 for the MXU; the
// weights here stay float32.  int8 levels are converted exactly to float and
// the level's dequant scale (a device array, written by the level quantizer
// of fpn_quant.cu, so the host never reads it) folds into the sample-mean
// factor once per RoI: inv_count * scale[lvl], exact because inv_count is a
// power of two, so the weight is ((wy*oky) * (wx*okx)) * (inv_count*scale)
// as in the plain version; the output is float32.  The per-RoI FPN level comes from the caller
// (computed with the same torch ops as the plain version) so an ulp of
// log2/sqrt on the device cannot move a RoI to another level.
//
// Backward design: the same grid; each thread takes one (RoI, bin, channel)
// cotangent g, multiplies it by the RoI's validity weight, and adds
// g * weight for each of the 16 taps of its 2x2 samples into the level the
// RoI was assigned to, with float32 atomicAdd.  For bf16 levels the adds go
// into a float32 workspace the size of the levels and a second pass rounds
// it to bf16 once; for f32 levels they go straight into the gradient.  The
// atomics add in an order that changes from run to run (as torchvision's
// CUDA roi_align backward does), so the result is not bit-repeatable.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// P2-P5: the caller's level indices are 0..3
constexpr int kLevels = 4;
// the forward's level types (hnd_roi_align_fwd's dtype)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kS8 = 2;

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// coord = start + bin*bin_size + samp*bin_size, evaluated left to right
__device__ __forceinline__ float sample_coord(float start, int bin, float samp,
                                              float bin_size) {
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

// T: the levels' type; O: the output's (T, or float for int8 levels).
// table_scale: [kLevels] dequant scales on the device (int8), else null.
template <typename T, typename O>
__global__ void roi_align_fwd_kernel(Levels levels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ box_level,
                                     const float* __restrict__ box_weight,
                                     const float* __restrict__ table_scale,
                                     O* __restrict__ out, int n_per_image,
                                     int C, int P, int S, float inv_count) {
  const int m = blockIdx.x / P;
  const int py = blockIdx.x % P;
  const int lvl = box_level[m];
  const int img = m / n_per_image;
  const RoiGeom g = roi_geom(boxes, m, levels.scale[lvl], levels.h[lvl],
                             levels.w[lvl], P);
  const T* __restrict__ feat =
      static_cast<const T*>(levels.ptr[lvl]) + (int64_t)img * g.H * g.W * C;
  // the box's validity weight multiplies the finished bin, as
  // `out * boxes_valid` does in the plain version
  const float valid = box_weight == nullptr ? 1.0f : box_weight[m];
  const float inv =
      table_scale == nullptr ? inv_count : __fmul_rn(inv_count, table_scale[lvl]);

  O* __restrict__ out_row = out + ((int64_t)m * P + py) * P * C;

  for (int px = 0; px < P; ++px) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.0f;
      for (int sy = 0; sy < S; ++sy) {
        const float samp_y = __fdiv_rn((float)sy + 0.5f, (float)S);
        const AxisSample ay =
            axis_sample(sample_coord(g.y1, py, samp_y, g.bin_h), g.fh);
        for (int sx = 0; sx < S; ++sx) {
          const float samp_x = __fdiv_rn((float)sx + 0.5f, (float)S);
          const AxisSample ax =
              axis_sample(sample_coord(g.x1, px, samp_x, g.bin_w), g.fw);
          const int ys[2] = {ay.lo, ay.hi};
          const float wys[2] = {ay.w_lo, ay.w_hi};
          const int xs[2] = {ax.lo, ax.hi};
          const float wxs[2] = {ax.w_lo, ax.w_hi};
#pragma unroll
          for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
            for (int cx = 0; cx < 2; ++cx) {
              const float wgt = __fmul_rn(__fmul_rn(wys[cy], wxs[cx]), inv);
              const float v =
                  to_float(feat[((int64_t)ys[cy] * g.W + xs[cx]) * C + c]);
              acc = __fadd_rn(acc, __fmul_rn(v, wgt));
            }
          }
        }
      }
      store(out_row + (int64_t)px * C + c, __fmul_rn(acc, valid));
    }
  }
}

template <typename T>
__global__ void roi_align_bwd_kernel(GradLevels grads,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ box_level,
                                     const float* __restrict__ box_weight,
                                     const T* __restrict__ grad_out,
                                     int n_per_image, int C, int P, int S,
                                     float inv_count) {
  const int m = blockIdx.x / P;
  const int py = blockIdx.x % P;
  const int lvl = box_level[m];
  const int img = m / n_per_image;
  const RoiGeom g = roi_geom(boxes, m, grads.scale[lvl], grads.h[lvl],
                             grads.w[lvl], P);
  float* __restrict__ dfeat = grads.ptr[lvl] + (int64_t)img * g.H * g.W * C;
  const float valid = box_weight == nullptr ? 1.0f : box_weight[m];
  const T* __restrict__ g_row = grad_out + ((int64_t)m * P + py) * P * C;

  for (int px = 0; px < P; ++px) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      // the plain autograd's order: (g * valid) * weight per tap
      const float gv = __fmul_rn(to_float(g_row[(int64_t)px * C + c]), valid);
      for (int sy = 0; sy < S; ++sy) {
        const float samp_y = __fdiv_rn((float)sy + 0.5f, (float)S);
        const AxisSample ay =
            axis_sample(sample_coord(g.y1, py, samp_y, g.bin_h), g.fh);
        for (int sx = 0; sx < S; ++sx) {
          const float samp_x = __fdiv_rn((float)sx + 0.5f, (float)S);
          const AxisSample ax =
              axis_sample(sample_coord(g.x1, px, samp_x, g.bin_w), g.fw);
          const int ys[2] = {ay.lo, ay.hi};
          const float wys[2] = {ay.w_lo, ay.w_hi};
          const int xs[2] = {ax.lo, ax.hi};
          const float wxs[2] = {ax.w_lo, ax.w_hi};
#pragma unroll
          for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
            for (int cx = 0; cx < 2; ++cx) {
              const float wgt =
                  __fmul_rn(__fmul_rn(wys[cy], wxs[cx]), inv_count);
              atomicAdd(dfeat + ((int64_t)ys[cy] * g.W + xs[cx]) * C + c,
                        __fmul_rn(gv, wgt));
            }
          }
        }
      }
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

bool bad_sizes(int64_t M, int n_per_image, int C, int P, int S) {
  return M <= 0 || n_per_image <= 0 || C <= 0 || P <= 0 || S <= 0 ||
         M * P > 0x7fffffffLL;
}

int threads_for(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

}  // namespace

extern "C" {

// level_ptrs: kLevels device pointers; level_hw: [h0, w0, h1, w1, ...];
// level_scales: kLevels floats (host arrays, copied into the launch).
// boxes [M, 4] f32, box_level [M] i32, box_weight [M] f32 or null;
// dtype: kF32, kBF16 or kS8, the levels' type; table_scale: kLevels f32
// dequant scales on the device for kS8, else null; out [M, P, P, C] in the
// levels' type, float32 for kS8.  RoI m belongs to image m / n_per_image.
int hnd_roi_align_fwd(const void* const* level_ptrs, const int* level_hw,
                      const float* level_scales, const float* boxes,
                      const int* box_level, const float* box_weight,
                      const float* table_scale, void* out, int64_t M,
                      int n_per_image, int C, int P, int sampling_ratio,
                      int dtype, void* stream) {
  if (bad_sizes(M, n_per_image, C, P, sampling_ratio) ||
      (dtype == kS8) != (table_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    levels.ptr[l] = level_ptrs[l];
    levels.h[l] = level_hw[2 * l];
    levels.w[l] = level_hw[2 * l + 1];
    levels.scale[l] = level_scales[l];
  }
  const float inv_count = 1.0f / (float)(sampling_ratio * sampling_ratio);
  const dim3 grid((unsigned)(M * P));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    roi_align_fwd_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<grid, threads_for(C), 0, s>>>(
            levels, boxes, box_level, box_weight, nullptr,
            static_cast<__nv_bfloat16*>(out), n_per_image, C, P,
            sampling_ratio, inv_count);
  else if (dtype == kS8)
    roi_align_fwd_kernel<int8_t, float><<<grid, threads_for(C), 0, s>>>(
        levels, boxes, box_level, box_weight, table_scale,
        static_cast<float*>(out), n_per_image, C, P, sampling_ratio,
        inv_count);
  else if (dtype == kF32)
    roi_align_fwd_kernel<float, float><<<grid, threads_for(C), 0, s>>>(
        levels, boxes, box_level, box_weight, nullptr,
        static_cast<float*>(out), n_per_image, C, P, sampling_ratio,
        inv_count);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// grad_ptrs: kLevels device pointers to zeroed f32 [B, H_l, W_l, C] buffers
// that the cotangent is added into; grad_out [M, P, P, C] (bf16 != 0:
// bfloat16, else f32); the other arguments as for hnd_roi_align_fwd.
int hnd_roi_align_bwd(float* const* grad_ptrs, const int* level_hw,
                      const float* level_scales, const float* boxes,
                      const int* box_level, const float* box_weight,
                      const void* grad_out, int64_t M, int n_per_image, int C,
                      int P, int sampling_ratio, int bf16, void* stream) {
  if (bad_sizes(M, n_per_image, C, P, sampling_ratio))
    return (int)cudaErrorInvalidValue;
  GradLevels grads;
  for (int l = 0; l < kLevels; ++l) {
    grads.ptr[l] = grad_ptrs[l];
    grads.h[l] = level_hw[2 * l];
    grads.w[l] = level_hw[2 * l + 1];
    grads.scale[l] = level_scales[l];
  }
  const float inv_count = 1.0f / (float)(sampling_ratio * sampling_ratio);
  const dim3 grid((unsigned)(M * P));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads_for(C), 0, s>>>(
        grads, boxes, box_level, box_weight,
        static_cast<const __nv_bfloat16*>(grad_out), n_per_image, C, P,
        sampling_ratio, inv_count);
  else
    roi_align_bwd_kernel<float><<<grid, threads_for(C), 0, s>>>(
        grads, boxes, box_level, box_weight,
        static_cast<const float*>(grad_out), n_per_image, C, P,
        sampling_ratio, inv_count);
  return (int)cudaGetLastError();
}

// dst[i] = bf16(src[i]), round to nearest even: the backward's second pass.
int hnd_f32_to_bf16(const float* src, void* dst, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132 * 32 ? want : 132 * 32);
  f32_to_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<__nv_bfloat16*>(dst), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
