// Fused ResNet stem for sm_90a: conv 7x7/s2 (3 -> 64 channels, pad 3) with
// the frozen-BN affine and ReLU, and the conv's weight gradient.
//
// Replaces hnd_ghnd_tpu/ops/pallas_stem.py: _stem_fwd_kernel and
// _stem_fwd_res_kernel (the forward, pallas_call at :185; the _res variant
// also writes the pre-affine conv for the backward) and _stem_dw_kernel
// (the weight gradient, pallas_call at :204).
//
// Bound on the H100 at batch 4, 832x1344 (the GHND distill bucket):
// operations.  Each of the three computes 4 * 416 * 672 * 64 * 147 =
// 10.5 G multiply-adds (21.0 GFLOP), 0.31 ms at the 67 TFLOP/s of fp32
// outside the tensor cores.  The bytes take less: the forward reads 54 MB
// and writes 286 MB (0.10 ms at 3.35 TB/s), the _res variant writes a
// second 286 MB (0.19 ms), dW reads 340 MB (0.10 ms).  TF32 tensor cores
// would compute another function (the config asks for float32), so the
// design keeps the FMA units fed from shared memory:
//
//   forward: one block per 8 x 32 output tile of one image, 256 threads,
//     one output pixel and all 64 channels per thread (64 accumulators in
//     registers).  The 3 x 21 x 69 input window (zero-padded at the image
//     edge) and the 147 x 64 weights sit in shared memory.  The window is
//     split into even and odd columns, so the stride-2 reads of a warp hit
//     32 consecutive words; the weights are read as float4 broadcasts.
//     One input read feeds 64 FMAs.  The epilogue applies the affine and
//     the ReLU and masks the ragged last tile.
//   dW: a fixed grid of blocks walks the same tiles in a fixed order.  A
//     thread owns 4 output channels x 10 taps (40 accumulators); per pixel
//     it reads one float4 of the cotangent and 10 broadcast inputs.  Each
//     block writes its [64, 147] partial sum to scratch, and a second pass
//     adds the partials in block order.  No float atomics: repeated steps
//     give the same bits.
//
// Sums run in another order than cuDNN's or the CPU's: the forward agrees
// with its plain version to ~1e-6 of the largest output, dW to ~1e-5 of
// the largest gradient.  Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kTaps = kCin * kK * kK;         // 147
constexpr int kTR = 8;                        // output rows per tile
constexpr int kTC = 32;                       // output columns per tile
constexpr int kThreads = kTR * kTC;           // one pixel per thread
constexpr int kWR = 2 * kTR + kK - 2;         // 21 input rows per tile
constexpr int kWC = 2 * kTC + kK - 2;         // 69 input columns per tile
constexpr int kHalf = (kWC + 1) / 2;          // 35 columns per parity
constexpr int kRowPitch = 2 * kHalf;          // even plane, then odd plane
constexpr int kWinFloats = kCin * kWR * kRowPitch;
constexpr int kFwdSmem = (kTaps * kCout + kWinFloats) * 4;
// dW: 16 channel groups of 4 x 16 tap groups of 10 (160 >= 147)
constexpr int kOGroups = kCout / 4;
constexpr int kTapsPerThread = 10;
constexpr int kGPitch = kCout + 4;            // keeps float4 rows aligned
constexpr int kDwSmem = (kThreads * kGPitch + kWinFloats) * 4;
constexpr int kDwMaxBlocks = 2 * 132;         // two per SM of an H100

// Stage the zero-padded input window of the tile at (oy0, ox0) of image b:
// rows 2*oy0-3 .., columns 2*ox0-3 .., column col stored at
// [c][r][col & 1][col >> 1].
__device__ __forceinline__ void load_window(const float* __restrict__ x,
                                            int H, int W, int b, int oy0,
                                            int ox0, float* xs) {
  const float* xb = x + (size_t)b * kCin * H * W;
  const int iy0 = 2 * oy0 - 3;
  const int ix0 = 2 * ox0 - 3;
  for (int i = threadIdx.x; i < kCin * kWR * kWC; i += blockDim.x) {
    const int col = i % kWC;
    const int r = (i / kWC) % kWR;
    const int c = i / (kWC * kWR);
    const int gy = iy0 + r;
    const int gx = ix0 + col;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = xb[((size_t)c * H + gy) * W + gx];
    }
    xs[(c * kWR + r) * kRowPitch + (col & 1) * kHalf + (col >> 1)] = v;
  }
}

template <bool kWithConv>
__global__ void __launch_bounds__(kThreads)
stem_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ conv, int H, int W) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [147][64]
  float* xs = ws + kTaps * kCout;
  const int OH = H / 2;
  const int OW = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTR;
  const int ox0 = blockIdx.x * kTC;
  for (int i = threadIdx.x; i < kCout * kTaps; i += kThreads) {
    ws[(i % kTaps) * kCout + i / kTaps] = w[i];  // OIHW -> [tap][o]
  }
  load_window(x, H, W, b, oy0, ox0, xs);
  __syncthreads();

  const int px = threadIdx.x % kTC;
  const int py = threadIdx.x / kTC;
  float acc[kCout];
#pragma unroll
  for (int o = 0; o < kCout; ++o) acc[o] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < kCin; ++c) {
#pragma unroll 1
    for (int ky = 0; ky < kK; ++ky) {
      const float* row = xs + (c * kWR + 2 * py + ky) * kRowPitch + px;
      const float* wrow = ws + (c * kK + ky) * kK * kCout;
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) {
        const float v = row[(kx & 1) * kHalf + (kx >> 1)];
        const float4* w4 = reinterpret_cast<const float4*>(wrow + kx * kCout);
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 wv = w4[q];
          acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int oy = oy0 + py;
  const int ox = ox0 + px;
  if (oy >= OH || ox >= OW) return;
  const size_t plane = (size_t)OH * OW;
  const size_t base = (size_t)b * kCout * plane + (size_t)oy * OW + ox;
#pragma unroll
  for (int o = 0; o < kCout; ++o) {
    if (kWithConv) conv[base + o * plane] = acc[o];
    // conv * scale + bias as two roundings, like the plain version
    const float y = __fadd_rn(__fmul_rn(acc[o], __ldg(scale + o)),
                              __ldg(bias + o));
    out[base + o * plane] = fmaxf(y, 0.0f);
  }
}

__device__ __forceinline__ void dw_geometry(int B, int H, int W, int& tiles_x,
                                            int& tiles_y, int& n_tiles) {
  tiles_x = (W / 2 + kTC - 1) / kTC;
  tiles_y = (H / 2 + kTR - 1) / kTR;
  n_tiles = B * tiles_y * tiles_x;
}

__global__ void __launch_bounds__(kThreads)
stem_dw_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       float* __restrict__ partials, int B, int H, int W) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);  // [pixel][kGPitch]
  float* xs = gs + kThreads * kGPitch;
  const int OH = H / 2;
  const int OW = W / 2;
  int tiles_x, tiles_y, n_tiles;
  dw_geometry(B, H, W, tiles_x, tiles_y, n_tiles);
  const int og = threadIdx.x % kOGroups;
  const int tg = threadIdx.x / kOGroups;
  // window offset of each of this thread's taps (past-the-end taps repeat
  // the last one and are not stored)
  int off[kTapsPerThread];
#pragma unroll
  for (int j = 0; j < kTapsPerThread; ++j) {
    const int t = min(tg * kTapsPerThread + j, kTaps - 1);
    const int c = t / (kK * kK);
    const int ky = (t / kK) % kK;
    const int kx = t % kK;
    off[j] = (c * kWR + ky) * kRowPitch + (kx & 1) * kHalf + (kx >> 1);
  }
  float acc[kTapsPerThread][4];
#pragma unroll
  for (int j = 0; j < kTapsPerThread; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  const size_t plane = (size_t)OH * OW;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ox0 = (tile % tiles_x) * kTC;
    const int oy0 = ((tile / tiles_x) % tiles_y) * kTR;
    const int b = tile / (tiles_x * tiles_y);
    __syncthreads();  // the previous tile is consumed
    load_window(x, H, W, b, oy0, ox0, xs);
    const float* gb = g + (size_t)b * kCout * plane;
    for (int i = threadIdx.x; i < kCout * kThreads; i += kThreads) {
      const int p = i % kThreads;
      const int o = i / kThreads;
      const int oy = oy0 + p / kTC;
      const int ox = ox0 + p % kTC;
      gs[p * kGPitch + o] = (oy < OH && ox < OW)
          ? gb[o * plane + (size_t)oy * OW + ox] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int p = 0; p < kThreads; ++p) {
      const float4 gv =
          *reinterpret_cast<const float4*>(gs + p * kGPitch + 4 * og);
      const float* xp = xs + 2 * (p / kTC) * kRowPitch + (p % kTC);
#pragma unroll
      for (int j = 0; j < kTapsPerThread; ++j) {
        const float v = xp[off[j]];
        acc[j][0] = fmaf(v, gv.x, acc[j][0]);
        acc[j][1] = fmaf(v, gv.y, acc[j][1]);
        acc[j][2] = fmaf(v, gv.z, acc[j][2]);
        acc[j][3] = fmaf(v, gv.w, acc[j][3]);
      }
    }
  }

  float* part = partials + (size_t)blockIdx.x * kCout * kTaps;
#pragma unroll
  for (int j = 0; j < kTapsPerThread; ++j) {
    const int t = tg * kTapsPerThread + j;
    if (t < kTaps) {
#pragma unroll
      for (int q = 0; q < 4; ++q) part[(4 * og + q) * kTaps + t] = acc[j][q];
    }
  }
}

// dw[i] = sum of the partials in block order (a fixed order).
__global__ void stem_dw_reduce_kernel(const float* __restrict__ partials,
                                      int n_partials, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kCout * kTaps) return;
  float s = 0.0f;
  for (int k = 0; k < n_partials; ++k) {
    s += partials[(size_t)k * kCout * kTaps + i];
  }
  dw[i] = s;
}

int dw_blocks(int B, int H, int W) {
  const int n_tiles = B * ((H / 2 + kTR - 1) / kTR) * ((W / 2 + kTC - 1) / kTC);
  return n_tiles < kDwMaxBlocks ? n_tiles : kDwMaxBlocks;
}

bool bad_shape(int B, int H, int W) {
  return B <= 0 || B > 65535 || H < 2 || W < 2 || (H & 1) || (W & 1) ||
         (H / 2 + kTR - 1) / kTR > 65535;
}

}  // namespace

extern "C" {

// x [B, 3, H, W], w [64, 3, 7, 7], scale/bias [64] -> out [B, 64, H/2, W/2];
// conv (same shape) is written too when it is not null.  All float32,
// contiguous, on the stream's device.
int hnd_stem_fwd(const float* x, const float* w, const float* scale,
                 const float* bias, float* out, float* conv, int B, int H,
                 int W, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W / 2 + kTC - 1) / kTC, (H / 2 + kTR - 1) / kTR, B);
  cudaError_t err;
  if (conv != nullptr) {
    err = cudaFuncSetAttribute(stem_fwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFwdSmem);
    if (err != cudaSuccess) return (int)err;
    stem_fwd_kernel<true><<<grid, kThreads, kFwdSmem, s>>>(
        x, w, scale, bias, out, conv, H, W);
  } else {
    err = cudaFuncSetAttribute(stem_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFwdSmem);
    if (err != cudaSuccess) return (int)err;
    stem_fwd_kernel<false><<<grid, kThreads, kFwdSmem, s>>>(
        x, w, scale, bias, out, nullptr, H, W);
  }
  return (int)cudaGetLastError();
}

// Number of floats the caller must allocate for hnd_stem_dw's partials.
int hnd_stem_dw_partials_size(int B, int H, int W) {
  if (bad_shape(B, H, W)) return 0;
  return dw_blocks(B, H, W) * kCout * kTaps;
}

// x [B, 3, H, W], g [B, 64, H/2, W/2] (the conv's cotangent) -> dw
// [64, 3, 7, 7], through partials of hnd_stem_dw_partials_size floats.
int hnd_stem_dw(const float* x, const float* g, float* partials, float* dw,
                int B, int H, int W, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dw_blocks(B, H, W);
  cudaError_t err = cudaFuncSetAttribute(
      stem_dw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwSmem);
  if (err != cudaSuccess) return (int)err;
  stem_dw_partial_kernel<<<blocks, kThreads, kDwSmem, s>>>(x, g, partials, B,
                                                           H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_dw_reduce_kernel<<<(kCout * kTaps + 255) / 256, 256, 0, s>>>(
      partials, blocks, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
