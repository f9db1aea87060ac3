// Multi-level RoIAlign forward (torchvision 0.4.2 semantics) for sm_90a.
//
// Replaces hnd_ghnd_tpu/ops/pallas_roi.py: pallas_multiscale_roi_align_batch
// (_roi_kernel with its _prep).  The TPU kernel's window-DMA classes, 8-row
// snapping and MXU y-contraction exist because of Mosaic's limits and are
// not carried over.
//
// Bound on the H100: gather bytes.  At the serving shapes (B=8, 1000 RoIs
// per image, 7x7 bins, 2x2 samples, C=256 f32) every sample reads 4 corner
// rows of 1 KB: 8000 * 196 * 4 * 1 KB = 6.4 GB of loads, largely served
// from the 50 MB L2 because neighbouring samples share corners and the P2-P5
// maps of one image are ~32 MB.  The output is 8000 * 49 KB = 400 MB.
//
// Design: one block per (RoI, output row); threads walk the channels, so the
// four corner rows of each sample are read as contiguous NHWC rows (one
// coalesced 128-byte segment per warp) and the bin is written straight to
// out[m, py, px, :].  The per-sample geometry is uniform across the block
// and recomputed by every thread (it is a few dozen flops against 4 KB of
// loads per sample).
//
// Arithmetic follows hnd_ghnd_tpu/ops/roi_align.py:_roi_align_flat (the XLA
// path) operation for operation, with __fmul_rn/__fadd_rn so nvcc cannot
// contract a multiply-add into an FMA: sample points are
// y1 + bin*bin_h + samp*bin_h, the border rules are those of
// _bilinear_params, and the bin sum runs in the same order
// (sample y, sample x, corner y, corner x) with the weight
// ((wy*oky) * (wx*okx)) * (1/s^2).  The per-RoI FPN level comes from the
// caller (computed with the same torch ops as the plain version) so an ulp
// of log2/sqrt on the device cannot move a RoI to another level.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// P2-P5: the caller's level indices are 0..3
constexpr int kLevels = 4;

struct Levels {
  const float* ptr[kLevels];  // [B, H_l, W_l, C] contiguous f32
  int h[kLevels];
  int w[kLevels];
  float scale[kLevels];
};

struct AxisSample {
  int lo, hi;
  float w_lo, w_hi;  // already multiplied by the in-range flag
};

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

__global__ void roi_align_fwd_kernel(Levels levels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ box_level,
                                     const float* __restrict__ box_weight,
                                     float* __restrict__ out, int n_per_image,
                                     int C, int P, int S, float inv_count) {
  const int m = blockIdx.x / P;
  const int py = blockIdx.x % P;
  const int lvl = box_level[m];
  const int img = m / n_per_image;
  const float scale = levels.scale[lvl];
  const int H = levels.h[lvl];
  const int W = levels.w[lvl];
  const float fh = (float)H;
  const float fw = (float)W;
  const float* __restrict__ feat =
      levels.ptr[lvl] + (int64_t)img * H * W * C;

  const float x1 = __fmul_rn(boxes[4 * m + 0], scale);
  const float y1 = __fmul_rn(boxes[4 * m + 1], scale);
  const float x2 = __fmul_rn(boxes[4 * m + 2], scale);
  const float y2 = __fmul_rn(boxes[4 * m + 3], scale);
  const float roi_w = fmaxf(__fsub_rn(x2, x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(y2, y1), 1.0f);
  const float bin_w = __fdiv_rn(roi_w, (float)P);
  const float bin_h = __fdiv_rn(roi_h, (float)P);
  // the box's validity weight multiplies the finished bin, as
  // `out * boxes_valid` does in the plain version
  const float valid = box_weight == nullptr ? 1.0f : box_weight[m];

  float* __restrict__ out_row = out + ((int64_t)m * P + py) * P * C;

  for (int px = 0; px < P; ++px) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.0f;
      for (int sy = 0; sy < S; ++sy) {
        const float samp_y = __fdiv_rn((float)sy + 0.5f, (float)S);
        const AxisSample ay =
            axis_sample(sample_coord(y1, py, samp_y, bin_h), fh);
        for (int sx = 0; sx < S; ++sx) {
          const float samp_x = __fdiv_rn((float)sx + 0.5f, (float)S);
          const AxisSample ax =
              axis_sample(sample_coord(x1, px, samp_x, bin_w), fw);
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
              const float v =
                  __ldg(feat + ((int64_t)ys[cy] * W + xs[cx]) * C + c);
              acc = __fadd_rn(acc, __fmul_rn(v, wgt));
            }
          }
        }
      }
      out_row[(int64_t)px * C + c] = __fmul_rn(acc, valid);
    }
  }
}

}  // namespace

extern "C" {

// level_ptrs: kLevels device pointers; level_hw: [h0, w0, h1, w1, ...];
// level_scales: kLevels floats (host arrays, copied into the launch).
// boxes [M, 4] f32, box_level [M] i32, box_weight [M] f32 or null,
// out [M, P, P, C] f32; RoI m belongs to image m / n_per_image.
int hnd_roi_align_fwd(const void* const* level_ptrs, const int* level_hw,
                      const float* level_scales, const float* boxes,
                      const int* box_level, const float* box_weight,
                      float* out, int64_t M,
                      int n_per_image, int C, int P, int sampling_ratio,
                      void* stream) {
  if (M <= 0 || n_per_image <= 0 || C <= 0 || P <= 0 || sampling_ratio <= 0 ||
      M * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    levels.ptr[l] = static_cast<const float*>(level_ptrs[l]);
    levels.h[l] = level_hw[2 * l];
    levels.w[l] = level_hw[2 * l + 1];
    levels.scale[l] = level_scales[l];
  }
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const float inv_count = 1.0f / (float)(sampling_ratio * sampling_ratio);
  roi_align_fwd_kernel<<<(unsigned)(M * P), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      levels, boxes, box_level, box_weight, out, n_per_image, C, P,
      sampling_ratio, inv_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
