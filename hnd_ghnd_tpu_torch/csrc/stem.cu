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
// design keeps the FMA units fed: each shared-memory load feeds many FMAs,
// no warp's shared-memory access has a bank conflict, and the next tile's
// input is in flight (cp.async into a second buffer) while a tile computes.
// The design before this one (one output pixel per thread, the weights
// restaged per tile through a 32-way bank conflict, no overlap of loads and
// FMAs) took 0.95 / 0.96 / 1.07 ms of card time (forward / with the conv /
// dW), ~30% of the bound; this one takes 0.53 / 0.55 / 0.60 ms, 52-60%
// (chip_roi_ab.py in turns on an H100 80GB HBM3 at 700 W; PERF.md).
//
//   forward: a persistent grid of two blocks per SM walks the 8 x 32 output
//     tiles of every image in a fixed order.  A block stages the 147 x 64
//     weights into shared memory once (consecutive threads write
//     consecutive words) and keeps two zero-padded 3 x 21 x 72 input
//     windows, each row split into its even and odd columns, so the
//     stride-2 taps of four neighbouring pixels are two float4 loads per
//     parity.  256 threads: warp w takes channels 16*(w%4) .. +15 and four
//     tile rows; a thread computes 4 neighbouring pixels of one row x 16
//     channels (64 accumulators).  Per (c, ky) row of the filter it loads
//     the 13 inputs its pixels need (four float4, consecutive threads on
//     consecutive addresses) and 28 float4 of weights, which every lane of
//     the warp reads at one address (a broadcast): 448 FMAs for 32 loads.
//     The epilogue applies the affine and the ReLU and writes 16-byte
//     vectors along x (streaming stores), one element at a time where the
//     row is ragged or the address unaligned.
//   dW: a persistent grid of one block per SM walks tiles of 6 x 32
//     outputs in a fixed order.  The cotangent tile sits in shared memory
//     as [pixel][64 channels], its 16-byte channel chunks XOR-swizzled by
//     the pixel, so that the staging copies (8 pixels x 4 channels a warp)
//     and the float4 reads are both free of bank conflicts; the input
//     window as 3 x 17 rows of 69 columns (an odd pitch: the rows a warp
//     reads fall in distinct banks).  504 threads compute (and 512 copy,
//     without a division per copy): a thread owns one (c, ky)
//     row of the filter (7 taps) x 8 channels (56 accumulators) and walks
//     two tile rows along x with the 7 inputs of its tap row in registers:
//     consecutive stride-2 pixels share 5, so each pixel loads 2 inputs and
//     two float4 of cotangent for 56 FMAs.  The three threads of each (tap
//     row, channels) walk different rows; the lanes of a warp share a pixel
//     and read 8 distinct chunks of it, one 128-byte line.  At the end the
//     block adds its three row sets in a fixed order and writes its
//     [64, 147] partial; a second pass adds the partials in block order.
//     No float atomics: repeated steps give the same bits.
//
//   bfloat16 (R12): JAX's Pallas stem runs in the input's dtype.  With bf16
//     x the weights are rounded to bf16 as they are staged (JAX's
//     .astype(x.dtype)), the output and the pre-affine conv are stored in
//     bf16, and dW takes bf16 x and cotangent; scale, bias and dW stay
//     float32.  A bf16 x bf16 product is exact in float32, so the same
//     float32 FMA main loop computes JAX's function: only the staging
//     (a load and a widening, since cp.async moves 4 bytes at least: each
//     thread loads all of its elements, then stores them) and the stores
//     differ.  Bound at batch 4, 832x1344: bytes, 0.051 ms forward and dW,
//     0.093 ms with the bf16 residual; 21.0 GFLOP at the bf16 tensor-core
//     rate is 0.021 ms, but this loop runs on the float32 FMA units (0.31
//     ms), so it stays far from the bound.  A tensor-core version ran
//     twice as fast, but more than STEM_BF16_DIFF_FRAC of its outputs on
//     a small input landed on the other bf16 neighbour of the plain
//     version's (its summation order and rounding both differ from this
//     loop's K-sequential float32 sum; which of the two moves them is not
//     measured), so this loop stays.
//
// Sums run in another order than cuDNN's or the CPU's: the forward agrees
// with its plain version to ~1e-6 of the largest output, dW to ~1e-5 of
// the largest gradient.  Build without --use_fast_math.

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCin = 3;
constexpr int kCout = 64;
constexpr int kK = 7;
constexpr int kTaps = kCin * kK * kK;         // 147
constexpr int kTC = 32;                       // output columns per tile

// forward
constexpr int kTR = 8;                        // output rows per tile
constexpr int kWR = 2 * kTR + kK - 2;         // 21 input rows per tile
constexpr int kFwdThreads = 256;
constexpr int kFwdBlocksPerSm = 2;
constexpr int kPix = 4;                       // pixels per thread, along x
constexpr int kChan = 16;                     // channels per thread
constexpr int kFwdCols = 72;                  // 69 input columns + float4 slack
constexpr int kHalf = kFwdCols / 2;           // even plane, then odd plane
constexpr int kFwdWin = kCin * kWR * kFwdCols;
constexpr int kFwdSmem = (kTaps * kCout + 2 * kFwdWin) * 4;
static_assert(kFwdThreads == (kCout / kChan) * kTR * (kTC / kPix),
              "a forward thread per 4 pixels x 16 channels of the tile");

// dW
constexpr int kDwTR = 6;                      // output rows per tile
constexpr int kDwWR = 2 * kDwTR + kK - 2;     // 17 input rows per tile
constexpr int kTapRows = kCin * kK;           // 21 (c, ky) rows of the filter
constexpr int kDwGroups = 8;                  // 8 channels each: chunks g, g+8
// threads per (tap row, channels), each walking every kDwParts-th row: 504
// threads that compute, in 16 warps (4 per scheduler, which leaves a
// thread 128 registers; 672 threads would leave 80, and the 56
// accumulators spill).  All 512 copy: warp k stages channel chunk k.
constexpr int kDwParts = 3;
constexpr int kDwWorkers = kTapRows * kDwGroups * kDwParts;  // 504
constexpr int kDwThreads = 512;
static_assert(kDwWorkers <= kDwThreads && kDwThreads == 32 * (kCout / 4),
              "a warp per channel chunk, a worker per (part, row, group)");
constexpr int kDwAcc = kK * 8;                // 56 accumulators
constexpr int kDwCols = 2 * kTC + kK - 2;     // 69: odd, window rows spread
constexpr int kDwWin = kCin * kDwWR * kDwCols;
constexpr int kGTile = kDwTR * kTC * kCout;
constexpr int kDwStage = kGTile + ((kDwWin + 3) & ~3);
constexpr int kDwSmem = 2 * kDwStage * 4;
static_assert(kDwAcc * kDwWorkers <= 2 * kDwStage,
              "the block's final sums reuse the staging buffers");
static_assert(kDwTR % kDwParts == 0, "each part walks whole rows");

struct Tiles {
  int tx, ty, n;
};

// The tiles of tr output rows x kTC columns of every image.
__host__ __device__ inline Tiles tiles_of(int B, int H, int W, int tr) {
  Tiles t;
  t.tx = (W / 2 + kTC - 1) / kTC;
  t.ty = (H / 2 + tr - 1) / tr;
  t.n = B * t.ty * t.tx;
  return t;
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(const Tiles& t, int i, int tr) {
  Tile r;
  r.ox0 = (i % t.tx) * kTC;
  r.oy0 = ((i / t.tx) % t.ty) * tr;
  r.b = i / (t.tx * t.ty);
  return r;
}

// One float from global to shared memory, asynchronously; zero when !in
// (src is then not read).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where window row i, position pos of tile t of x comes from (as
// window_async lays it out): the source pointer and whether it lies in the
// image (the zero padding does not).
template <int kRows, int kPitch, bool kSplit, typename T>
__device__ __forceinline__ const T* window_src(const T* xb, int H, int W,
                                               Tile t, int i, int pos,
                                               bool* in) {
  const int c = i / kRows;
  const int gy = 2 * t.oy0 - 3 + i - c * kRows;
  const int col = !kSplit ? pos
                  : pos < kPitch / 2 ? 2 * pos : 2 * (pos - kPitch / 2) + 1;
  const int gx = 2 * t.ox0 - 3 + col;
  *in = gy >= 0 && gy < H && gx >= 0 && gx < W;
  return *in ? xb + ((size_t)c * H + gy) * W + gx : xb;
}

// Stage the zero-padded input window of tile t of image x as float: window
// row r of channel c is image row 2*oy0-3+r, and position pos of it holds
// image column 2*ox0-3+col, at xs[(c * kRows + r) * kPitch + pos]: col = pos,
// or with kSplit the even columns first, col = 2*pos, then the odd ones,
// col = 2*(pos - kPitch/2) + 1.  Warps take whole rows and lanes
// consecutive positions, so a copy needs no division.  float32 goes through
// cp.async (in flight until the caller waits); bfloat16 is loaded into
// registers, all of a thread's elements first, then widened and stored.
template <int kRows, int kPitch, bool kSplit, int kThreads, typename T>
__device__ __forceinline__ void window_async(const T* __restrict__ x, int H,
                                             int W, Tile t, float* xs) {
  const T* xb = x + (size_t)t.b * kCin * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int kN = kCin * kRows;
  if constexpr (std::is_same<T, float>::value) {
    for (int i = warp; i < kN; i += kWarps) {
      const int c = i / kRows;
      const int gy = 2 * t.oy0 - 3 + i - c * kRows;
      const bool row_in = gy >= 0 && gy < H;
      const float* src = xb + ((size_t)c * H + (row_in ? gy : 0)) * W;
      for (int pos = lane; pos < kPitch; pos += 32) {
        const int col = !kSplit ? pos
                        : pos < kPitch / 2 ? 2 * pos
                                           : 2 * (pos - kPitch / 2) + 1;
        const int gx = 2 * t.ox0 - 3 + col;
        const bool in = row_in && gx >= 0 && gx < W;
        cp_async_f32(xs + i * kPitch + pos, in ? src + gx : xb, in);
      }
    }
  } else {
    constexpr int kRowIt = (kN + kWarps - 1) / kWarps;
    constexpr int kPosIt = (kPitch + 31) / 32;
    __nv_bfloat16 v[kRowIt][kPosIt];
#pragma unroll
    for (int a = 0; a < kRowIt; ++a) {
#pragma unroll
      for (int b = 0; b < kPosIt; ++b) {
        const int i = warp + a * kWarps;
        const int pos = lane + 32 * b;
        bool in = false;
        const T* src = xb;
        if (i < kN && pos < kPitch)
          src = window_src<kRows, kPitch, kSplit>(xb, H, W, t, i, pos, &in);
        v[a][b] = in ? *src : __float2bfloat16_rn(0.0f);
      }
    }
#pragma unroll
    for (int a = 0; a < kRowIt; ++a) {
#pragma unroll
      for (int b = 0; b < kPosIt; ++b) {
        const int i = warp + a * kWarps;
        const int pos = lane + 32 * b;
        if (i < kN && pos < kPitch)
          xs[i * kPitch + pos] = __bfloat162float(v[a][b]);
      }
    }
  }
}

// A staged weight: float32 as it is, or rounded to bfloat16 for bf16
// inputs (JAX's wmat.astype(x.dtype)), then held as float (exactly).
template <typename T>
__device__ __forceinline__ float staged_weight(float w) {
  if constexpr (std::is_same<T, float>::value) {
    return w;
  } else {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
}

// kPix consecutive floats of a row: one 16-byte streaming store when all
// are in the row and the address allows it, else one by one (the first n).
__device__ __forceinline__ void store_pixels(float* p, const float (&v)[kPix],
                                             int n) {
  if (n == kPix && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (j < n) __stcs(p + j, v[j]);
  }
}

// The same in bfloat16, each value rounded to nearest even: one 8-byte
// store when it can.
__device__ __forceinline__ void store_pixels(__nv_bfloat16* p,
                                             const float (&v)[kPix], int n) {
  if (n == kPix && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), u);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// T: the type of x, out and conv (float or __nv_bfloat16); the weights,
// scale and bias are float32, the sums and the affine float32.
template <bool kWithConv, typename T>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
stem_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out,
                T* __restrict__ conv, int B, int H, int W) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [147][64]
  float* win = ws + kTaps * kCout;              // two input windows
  const int OH = H / 2;
  const int OW = W / 2;
  const Tiles tiles = tiles_of(B, H, W, kTR);
  int tile = blockIdx.x;
  // the first window is in flight while the weights are staged
  window_async<kWR, kFwdCols, true, kFwdThreads>(
      x, H, W, tile_at(tiles, tile, kTR), win);
  cp_async_commit();
  for (int i = threadIdx.x; i < kTaps * kCout; i += kFwdThreads) {
    // OIHW -> [tap][o]
    ws[i] = staged_weight<T>(__ldg(w + (i % kCout) * kTaps + i / kCout));
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o0 = kChan * (warp & 3);               // first channel
  const int r = (warp >> 2) * 4 + (lane >> 3);     // tile row
  const int q = lane & 7;                          // pixels 4q .. 4q+3
  const size_t plane = (size_t)OH * OW;

#pragma unroll 1
  for (int k = 0; tile < tiles.n; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < tiles.n)
      window_async<kWR, kFwdCols, true, kFwdThreads>(
          x, H, W, tile_at(tiles, next, kTR), win + ((k + 1) & 1) * kFwdWin);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's window (and, at first, the weights)
    __syncthreads();
    const float* xs = win + (k & 1) * kFwdWin;

    float acc[kPix][kChan];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int o = 0; o < kChan; ++o) acc[p][o] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < kCin; ++c) {
#pragma unroll 1
      for (int ky = 0; ky < kK; ++ky) {
        // window columns 8q .. 8q+12 of row 2r+ky: xv[j] = column 8q + j
        const float* row = xs + (c * kWR + 2 * r + ky) * kFwdCols + 4 * q;
        const float4 e0 = *reinterpret_cast<const float4*>(row);
        const float4 e1 = *reinterpret_cast<const float4*>(row + 4);
        const float4 d0 = *reinterpret_cast<const float4*>(row + kHalf);
        const float4 d1 = *reinterpret_cast<const float4*>(row + kHalf + 4);
        const float xv[13] = {e0.x, d0.x, e0.y, d0.y, e0.z, d0.z, e0.w,
                              d0.w, e1.x, d1.x, e1.y, d1.y, e1.z};
        const float4* w4 = reinterpret_cast<const float4*>(
            ws + (c * kK + ky) * kK * kCout + o0);
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
          for (int g = 0; g < kChan / 4; ++g) {
            const float4 wv = w4[kx * (kCout / 4) + g];
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              const float v = xv[2 * p + kx];
              acc[p][4 * g + 0] = fmaf(v, wv.x, acc[p][4 * g + 0]);
              acc[p][4 * g + 1] = fmaf(v, wv.y, acc[p][4 * g + 1]);
              acc[p][4 * g + 2] = fmaf(v, wv.z, acc[p][4 * g + 2]);
              acc[p][4 * g + 3] = fmaf(v, wv.w, acc[p][4 * g + 3]);
            }
          }
        }
      }
    }

    const Tile t = tile_at(tiles, tile, kTR);
    const int oy = t.oy0 + r;
    const int ox = t.ox0 + kPix * q;
    if (oy < OH && ox < OW) {
      const int n = min(kPix, OW - ox);
      const size_t base =
          ((size_t)t.b * kCout + o0) * plane + (size_t)oy * OW + ox;
#pragma unroll
      for (int o = 0; o < kChan; ++o) {
        const float s = __ldg(scale + o0 + o);
        const float bi = __ldg(bias + o0 + o);
        float y[kPix];
        float cv[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          cv[p] = acc[p][o];
          // conv * scale + bias as two roundings, like the plain version
          y[p] = fmaxf(__fadd_rn(__fmul_rn(acc[p][o], s), bi), 0.0f);
        }
        if (kWithConv) store_pixels(conv + base + o * plane, cv, n);
        store_pixels(out + base + o * plane, y, n);
      }
    }
    __syncthreads();  // this window is consumed: the next prefetch reuses it
  }
}

// Start copying tile t's cotangent and input window into stage: the
// cotangent as [pixel][64], chunk k (channels 4k .. 4k+3) of pixel p at
// 4 * (k ^ (p & 7)); warp k copies chunk k, 8 pixels x 4 channels at a
// time, so the 32 words land in 32 banks.  Then the input window
// (window_async, 69 columns a row).  bfloat16 is loaded and widened as
// window_async does it.
template <typename T>
__device__ __forceinline__ void dw_tile_async(const T* __restrict__ x,
                                              const T* __restrict__ g,
                                              int H, int W, Tile t,
                                              float* stage) {
  const int OH = H / 2;
  const int OW = W / 2;
  const size_t plane = (size_t)OH * OW;
  const int lane = threadIdx.x & 31;
  const int chunk = threadIdx.x >> 5;
  const int px8 = lane >> 2;                   // p & 7
  const T* gb = g + (size_t)t.b * kCout * plane;
  const T* go = gb + (4 * chunk + (lane & 3)) * plane;
  float* dst = stage + px8 * kCout + 4 * (chunk ^ px8) + (lane & 3);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int row = 0; row < kDwTR; ++row) {
      const int oy = t.oy0 + row;
#pragma unroll
      for (int px = 0; px < kTC; px += 8) {
        const int ox = t.ox0 + px + px8;
        const bool in = oy < OH && ox < OW;
        cp_async_f32(dst + (row * kTC + px) * kCout,
                     in ? go + (size_t)oy * OW + ox : gb, in);
      }
    }
  } else {
    __nv_bfloat16 v[kDwTR][kTC / 8];
#pragma unroll
    for (int row = 0; row < kDwTR; ++row) {
      const int oy = t.oy0 + row;
#pragma unroll
      for (int px = 0; px < kTC; px += 8) {
        const int ox = t.ox0 + px + px8;
        v[row][px / 8] = oy < OH && ox < OW ? go[(size_t)oy * OW + ox]
                                            : __float2bfloat16_rn(0.0f);
      }
    }
#pragma unroll
    for (int row = 0; row < kDwTR; ++row)
#pragma unroll
      for (int px = 0; px < kTC; px += 8)
        dst[(row * kTC + px) * kCout] = __bfloat162float(v[row][px / 8]);
  }
  window_async<kDwWR, kDwCols, false, kDwThreads>(x, H, W, t, stage + kGTile);
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads, 1)
stem_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ partials, int B, int H, int W) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);  // two of kDwStage
  const Tiles tiles = tiles_of(B, H, W, kDwTR);
  const bool worker = threadIdx.x < kDwWorkers;           // the rest copy
  const int part = threadIdx.x / (kTapRows * kDwGroups);  // rows part, +3
  const int j = threadIdx.x % (kTapRows * kDwGroups);
  const int tap_row = j / kDwGroups;                      // c * 7 + ky
  const int cg = j % kDwGroups;     // channels 4cg .. +3 and 32+4cg .. +3
  const int c = tap_row / kK;
  const int ky = tap_row % kK;

  float acc[kK][8];
#pragma unroll
  for (int kx = 0; kx < kK; ++kx)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[kx][e] = 0.0f;

  int tile = blockIdx.x;
  dw_tile_async(x, g, H, W, tile_at(tiles, tile, kDwTR), stages);
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; tile < tiles.n; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < tiles.n)
      dw_tile_async(x, g, H, W, tile_at(tiles, next, kDwTR),
                    stages + ((k + 1) & 1) * kDwStage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* gs = stages + (k & 1) * kDwStage;
    const float* xs = gs + kGTile;
#pragma unroll 1
    for (int rr = 0; worker && rr < kDwTR / kDwParts; ++rr) {
      const int row = part + kDwParts * rr;
      // input columns 2*px .. 2*px+6 of window row 2*row+ky feed pixel px
      const float* xr = xs + (c * kDwWR + 2 * row + ky) * kDwCols;
      const float* gp = gs + row * kTC * kCout;
      float xv[kK];
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) xv[kx] = xr[kx];
#pragma unroll
      for (int px = 0; px < kTC; ++px) {
        const int sw = cg ^ (px & 7);
        const float4 g0 =
            *reinterpret_cast<const float4*>(gp + px * kCout + 4 * sw);
        const float4 g1 =
            *reinterpret_cast<const float4*>(gp + px * kCout + 4 * (sw + 8));
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          const float v = xv[kx];
          acc[kx][0] = fmaf(v, g0.x, acc[kx][0]);
          acc[kx][1] = fmaf(v, g0.y, acc[kx][1]);
          acc[kx][2] = fmaf(v, g0.z, acc[kx][2]);
          acc[kx][3] = fmaf(v, g0.w, acc[kx][3]);
          acc[kx][4] = fmaf(v, g1.x, acc[kx][4]);
          acc[kx][5] = fmaf(v, g1.y, acc[kx][5]);
          acc[kx][6] = fmaf(v, g1.z, acc[kx][6]);
          acc[kx][7] = fmaf(v, g1.w, acc[kx][7]);
        }
        if (px + 1 < kTC) {
#pragma unroll
          for (int kx = 0; kx + 2 < kK; ++kx) xv[kx] = xv[kx + 2];
          xv[kK - 2] = xr[2 * px + kK];
          xv[kK - 1] = xr[2 * px + kK + 1];
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next prefetch reuses it
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's sum: the parts of each (tap row, channels), in part order,
  // through shared memory laid out [accumulator][thread]
  float* red = stages;
  if (worker) {
#pragma unroll
    for (int kx = 0; kx < kK; ++kx)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(kx * 8 + e) * kDwWorkers + threadIdx.x] = acc[kx][e];
  }
  __syncthreads();
  constexpr int kPerPart = kTapRows * kDwGroups;  // 168
  float* out = partials + (size_t)blockIdx.x * kCout * kTaps;
  for (int i = threadIdx.x; i < kDwAcc * kPerPart; i += kDwThreads) {
    const int a = i / kPerPart;
    const int jj = i % kPerPart;
    float s = red[a * kDwWorkers + jj];
#pragma unroll
    for (int p = 1; p < kDwParts; ++p)
      s += red[a * kDwWorkers + p * kPerPart + jj];
    const int kx = a / 8;
    const int e = a % 8;
    const int gg = jj % kDwGroups;
    const int o = (e < 4 ? 4 * gg : 32 + 4 * gg - 4) + e;
    out[o * kTaps + (jj / kDwGroups) * kK + kx] = s;
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

bool bad_shape(int B, int H, int W) {
  if (B <= 0 || H < 2 || W < 2 || (H & 1) || (W & 1)) return true;
  const Tiles t = tiles_of(1, H, W, kDwTR < kTR ? kDwTR : kTR);
  return (int64_t)B * t.tx * t.ty > (int64_t)INT32_MAX;
}

// The persistent grids: blocks_per_sm blocks on each SM of the current
// device, fewer when there are fewer tiles.
cudaError_t grid_blocks(int B, int H, int W, int tr, int blocks_per_sm,
                        int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n = tiles_of(B, H, W, tr).n;
  *blocks = n < blocks_per_sm * sms ? n : blocks_per_sm * sms;
  return cudaSuccess;
}

// Let `kernel` use `bytes` of dynamic shared memory: set once per device
// (the attribute holds for the process), not on every launch.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes,
                        std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The shared-memory opt-in of each instantiation, per device.
template <bool kWithConv, typename T>
std::atomic<unsigned> fwd_ready{0};
template <typename T>
std::atomic<unsigned> dw_ready{0};

template <typename T>
cudaError_t launch_fwd(const void* x, const float* w, const float* scale,
                       const float* bias, void* out, void* conv, int B, int H,
                       int W, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = grid_blocks(B, H, W, kTR, kFwdBlocksPerSm, &blocks);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  if (conv != nullptr) {
    err = opt_in_smem(stem_fwd_kernel<true, T>, kFwdSmem,
                      fwd_ready<true, T>);
    if (err != cudaSuccess) return err;
    stem_fwd_kernel<true, T><<<blocks, kFwdThreads, kFwdSmem, s>>>(
        xt, w, scale, bias, static_cast<T*>(out), static_cast<T*>(conv), B,
        H, W);
  } else {
    err = opt_in_smem(stem_fwd_kernel<false, T>, kFwdSmem,
                      fwd_ready<false, T>);
    if (err != cudaSuccess) return err;
    stem_fwd_kernel<false, T><<<blocks, kFwdThreads, kFwdSmem, s>>>(
        xt, w, scale, bias, static_cast<T*>(out), nullptr, B, H, W);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* partials,
                      float* dw, int B, int H, int W, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = grid_blocks(B, H, W, kDwTR, 1, &blocks);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(stem_dw_partial_kernel<T>, kDwSmem, dw_ready<T>);
  if (err != cudaSuccess) return err;
  stem_dw_partial_kernel<T><<<blocks, kDwThreads, kDwSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stem_dw_reduce_kernel<<<(kCout * kTaps + 255) / 256, 256, 0, s>>>(
      partials, blocks, dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, 3, H, W], w [64, 3, 7, 7], scale/bias [64] -> out [B, 64, H/2, W/2];
// conv (same shape) is written too when it is not null.  x, out and conv
// are float32, or bfloat16 when bf16 is not 0; w, scale and bias float32.
// All contiguous, on the stream's device.
int hnd_stem_fwd(const void* x, const float* w, const float* scale,
                 const float* bias, void* out, void* conv, int B, int H,
                 int W, int bf16, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_fwd<__nv_bfloat16>(x, w, scale, bias, out, conv,
                                                B, H, W, s)
                    : launch_fwd<float>(x, w, scale, bias, out, conv, B, H,
                                        W, s));
}

// Number of floats the caller must allocate for hnd_stem_dw's partials
// (one [64, 147] sum per block of the grid); 0 if the shape is refused.
int hnd_stem_dw_partials_size(int B, int H, int W) {
  int blocks = 0;
  if (bad_shape(B, H, W) ||
      grid_blocks(B, H, W, kDwTR, 1, &blocks) != cudaSuccess)
    return 0;
  return blocks * kCout * kTaps;
}

// x [B, 3, H, W], g [B, 64, H/2, W/2] (the conv's cotangent; both float32,
// or both bfloat16 when bf16 is not 0) -> dw [64, 3, 7, 7] float32, through
// partials of hnd_stem_dw_partials_size floats.
int hnd_stem_dw(const void* x, const void* g, float* partials, float* dw,
                int B, int H, int W, int bf16, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dw<__nv_bfloat16>(x, g, partials, dw, B, H, W, s)
                    : launch_dw<float>(x, g, partials, dw, B, H, W, s));
}

}  // extern "C"
