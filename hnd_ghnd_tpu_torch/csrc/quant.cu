// Affine 8-bit quantize / dequantize of the bottleneck tensor for sm_90a.
//
// Replaces hnd_ghnd_tpu/ops/pallas_quant.py: pallas_quantize (_quant_kernel,
// with its min/max as an XLA reduction outside the kernel) and
// pallas_dequantize (_dequant_kernel).
//
// Bound on the H100: bytes.  Quantize reads 4 B and writes 1 B per element,
// dequantize the reverse; the tensor is [B, 212, 340, 3] f32 (6.9 MB at
// B=8), so each pass is a few microseconds of HBM time and launch latency
// dominates.  The design keeps the passes few and wide: 16-byte loads,
// grid-stride loops, and scale/zero point kept on the device so the host
// never waits between the passes.
//
// Quantize is three launches on one stream:
//   1. per-block min/max (warp shuffles, then shared memory) into partials;
//   2. one block reduces the partials and writes [scale, zero_point];
//   3. the elementwise quantize, reading [scale, zero_point].
// min/max is exact in any order, so the result does not depend on the
// grid.  No float atomics are used.
//
// Bit-exactness with codec/quantizer.py:quantize_tensor (the CPU formula):
//   * divisions are IEEE round-to-nearest (__fdiv_rn), never a
//     reciprocal-multiply;
//   * additions and products go through __fadd_rn/__fmul_rn so nvcc cannot
//     contract them into an FMA the CPU formula does not have;
//   * rounding is rintf (half to even, like jnp.round / torch.round), never
//     roundf (half away from zero);
//   * the zero point truncates toward zero (int cast), as the reference's
//     int(...) does.
// Build without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartialBlocks = 1024;

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Block-wide min/max of (lo, hi); the result is valid in thread 0.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[32];
  __shared__ float s_hi[32];
  warp_minmax(lo, hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  if (warp == 0) {
    lo = lane < n_warps ? s_lo[lane] : INFINITY;
    hi = lane < n_warps ? s_hi[lane] : -INFINITY;
    warp_minmax(lo, hi);
  }
}

__global__ void minmax_partial_kernel(const float* __restrict__ x, int64_t n,
                                      float* __restrict__ partials) {
  float lo = INFINITY, hi = -INFINITY;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
      hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
      lo = fminf(lo, x[i]);
      hi = fmaxf(hi, x[i]);
    }
  } else {
    for (int64_t i = tid; i < n; i += stride) {
      lo = fminf(lo, x[i]);
      hi = fmaxf(hi, x[i]);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = lo;
    partials[2 * blockIdx.x + 1] = hi;
  }
}

// One block: reduce the partials, then the scalar arithmetic of
// quantize_tensor in its exact order.  meta = [scale, zero_point].
__global__ void finalize_kernel(const float* __restrict__ partials,
                                int n_partials, float qmax,
                                float* __restrict__ meta) {
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x) {
    lo = fminf(lo, partials[2 * i]);
    hi = fmaxf(hi, partials[2 * i + 1]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    const float raw_scale = __fdiv_rn(__fsub_rn(hi, lo), qmax);
    const float scale = raw_scale > 0.0f ? raw_scale : 1.0f;
    const float initial_zp = __fsub_rn(0.0f, __fdiv_rn(lo, scale));
    const float clipped = fminf(fmaxf(initial_zp, 0.0f), qmax);
    meta[0] = scale;
    meta[1] = (float)(int)clipped;  // truncation toward zero
  }
}

__device__ __forceinline__ uint8_t quant_one(float v, float scale, float zp,
                                             float qmax) {
  const float q = fminf(fmaxf(__fadd_rn(zp, __fdiv_rn(v, scale)), 0.0f), qmax);
  return (uint8_t)rintf(q);  // half to even
}

__global__ void quantize_kernel(const float* __restrict__ x, int64_t n,
                                const float* __restrict__ meta, float qmax,
                                uint8_t* __restrict__ q) {
  const float scale = meta[0];
  const float zp = meta[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uchar4* q4 = reinterpret_cast<uchar4*>(q);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_uchar4(quant_one(v.x, scale, zp, qmax),
                          quant_one(v.y, scale, zp, qmax),
                          quant_one(v.z, scale, zp, qmax),
                          quant_one(v.w, scale, zp, qmax));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
      q[i] = quant_one(x[i], scale, zp, qmax);
    }
  } else {
    for (int64_t i = tid; i < n; i += stride) {
      q[i] = quant_one(x[i], scale, zp, qmax);
    }
  }
}

__device__ __forceinline__ float dequant_one(uint8_t v, float scale, float zp) {
  return __fmul_rn(scale, __fsub_rn((float)v, zp));
}

__global__ void dequantize_kernel(const uint8_t* __restrict__ q, int64_t n,
                                  const float* __restrict__ scale_ptr,
                                  const float* __restrict__ zp_ptr,
                                  float* __restrict__ out) {
  const float scale = *scale_ptr;
  const float zp = *zp_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(q) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int64_t n4 = n / 4;
    const uchar4* q4 = reinterpret_cast<const uchar4*>(q);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const uchar4 v = q4[i];
      out4[i] = make_float4(dequant_one(v.x, scale, zp),
                            dequant_one(v.y, scale, zp),
                            dequant_one(v.z, scale, zp),
                            dequant_one(v.w, scale, zp));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
      out[i] = dequant_one(q[i], scale, zp);
    }
  } else {
    for (int64_t i = tid; i < n; i += stride) {
      out[i] = dequant_one(q[i], scale, zp);
    }
  }
}

int grid_for(int64_t n) {
  // enough blocks for one float4 per thread, capped at 8 blocks per SM
  const int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > 8 * 132 ? 8 * 132 : blocks));
}

}  // namespace

extern "C" {

// Number of floats the caller must allocate for the partials buffer.
int hnd_quantize_partials_size(int64_t n) {
  const int g = grid_for(n);
  return 2 * (g < kMaxPartialBlocks ? g : kMaxPartialBlocks);
}

int hnd_quantize_u8(const float* x, uint8_t* q, float* partials, float* meta,
                    int64_t n, int num_bits, void* stream) {
  if (n <= 0 || num_bits < 1 || num_bits > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = (float)((1 << num_bits) - 1);
  int g_partial = grid_for(n);
  if (g_partial > kMaxPartialBlocks) g_partial = kMaxPartialBlocks;
  minmax_partial_kernel<<<g_partial, kThreads, 0, s>>>(x, n, partials);
  finalize_kernel<<<1, 1024, 0, s>>>(partials, g_partial, qmax, meta);
  quantize_kernel<<<grid_for(n), kThreads, 0, s>>>(x, n, meta, qmax, q);
  return (int)cudaGetLastError();
}

// scale and zero_point are device scalars (quantize writes them to meta[0]
// and meta[1]; the wire may deliver them elsewhere).
int hnd_dequantize_u8(const uint8_t* q, const float* scale,
                      const float* zero_point, float* out, int64_t n,
                      void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dequantize_kernel<<<grid_for(n), kThreads, 0, s>>>(q, n, scale, zero_point,
                                                     out);
  return (int)cudaGetLastError();
}

}  // extern "C"
