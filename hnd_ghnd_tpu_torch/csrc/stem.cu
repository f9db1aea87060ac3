// Fused ResNet stem for sm_90a: conv 7x7/s2 (3 -> 64 channels, pad 3) with
// the frozen-BN affine and ReLU, and the conv's weight gradient.
//
// Replaces hnd_ghnd_tpu/ops/pallas_stem.py: _stem_fwd_kernel and
// _stem_fwd_res_kernel (the forward, pallas_call at :185; the _res variant
// also writes the pre-affine conv for the backward) and _stem_dw_kernel
// (the weight gradient, pallas_call at :204).
//
// Bound on the H100 at batch 4, 832x1344 (the GHND distill bucket), float32:
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
//   bfloat16 (R12, R13): JAX's Pallas stem runs in the input's dtype.  With
//     bf16 x the weights are rounded to bf16 (JAX's .astype(x.dtype)), the
//     output and the pre-affine conv are stored in bf16, and dW takes bf16
//     x and cotangent; scale, bias and dW stay float32.  Bounds at batch 4,
//     832x1344: bytes, 0.0507 ms forward and dW, 0.0935 ms with the bf16
//     residual; 21.0 GFLOP at the bf16 tensor-core rate is 0.021 ms.
//   bf16 forward: the float32 FMA loop above (a bf16 x bf16 product is
//     exact in float32; the bf16 is widened as it is staged, by loads into
//     registers since cp.async moves 4 bytes at least), bit-equal to the
//     plain version on every tested shape: 0.56 / 0.57 ms on the card, 9%
//     / 16% of the bound.  It stays because its bits are the contract.  A
//     tensor-core forward with an exact repair was measured and not kept
//     (ROADMAP R13): it equalled this loop bit for bit, but recomputed
//     1.1% of the outputs (3.4% with the residual) on the FMA units and
//     took 0.62 / 0.77 ms.
//   bf16 dW (stem_dw_mma_kernel): a GEMM on the tensor cores, mma.sync
//     m16n8k16 bf16 -> float32 with M = 64 channels (A: the cotangent), N =
//     the 21 (c, ky) rows of the filter as n8 tiles of 8 taps (kx 0..6 and
//     a discarded one; B: the input), K = the pixels.  Bound by bytes: it
//     streams g (143 MB) and x (27 MB).  One block per SM walks tiles of
//     8 x 32 outputs; 4 load warps copy each tile's cotangent by 16-byte
//     cp.async (a ring of three, chunks XOR-swizzled for conflict-free
//     ldmatrix) and its input columns as they are, then build the window's
//     two parity planes of 4-byte pixel pairs (every tap's B fragment one
//     aligned 32-bit load); 7 MMA warps (3 filter rows x 64 channels each)
//     run the 16 k steps of a tile back to back, handed each tile through
//     named barriers.  The sums are promoted into float32 registers
//     (__fadd_rn) every 8 k steps: promoting at all took the error on the
//     cancelling case from ~8e-6 to ~5e-7 of the largest gradient, more
//     often than every 8 steps did not lower it further (PERF.md; the
//     interval is kMmaPromote).  The per-block partials and the reduce
//     are the float32 kernel's, so repeated calls give the same bits.
//     0.11 ms on the card, 46% of the bound (0.64 ms for the FMA loop it
//     replaced; chip_roi_ab.py in turns, H100 80GB HBM3 at 700 W).

// Sums run in another order than cuDNN's or the CPU's: the float32
// forward agrees with its plain version to ~1e-6 of the largest output, dW
// (float32 and bf16) to ~1e-5 of the largest gradient.  Build without
// --use_fast_math.

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
// (window_async, 69 columns a row).
__device__ __forceinline__ void dw_tile_async(const float* __restrict__ x,
                                              const float* __restrict__ g,
                                              int H, int W, Tile t,
                                              float* stage) {
  const int OH = H / 2;
  const int OW = W / 2;
  const size_t plane = (size_t)OH * OW;
  const int lane = threadIdx.x & 31;
  const int chunk = threadIdx.x >> 5;
  const int px8 = lane >> 2;                   // p & 7
  const float* gb = g + (size_t)t.b * kCout * plane;
  const float* go = gb + (4 * chunk + (lane & 3)) * plane;
  float* dst = stage + px8 * kCout + 4 * (chunk ^ px8) + (lane & 3);
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
  window_async<kDwWR, kDwCols, false, kDwThreads>(x, H, W, t, stage + kGTile);
}

// float32 dW on the FMA units.
__global__ void __launch_bounds__(kDwThreads, 1)
stem_dw_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
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

// bf16 dW on the tensor cores: dW[co][tap] = sum over pixels of
// g[co][p] * patch[p][tap], a GEMM with M = 64 channels, N = the 21 (c, ky)
// rows of the filter, each an n8 tile (kx 0..6 and a discarded eighth tap),
// and K = the pixels, 16 a k step of mma.sync m16n8k16 (bf16 in, float32
// out).  A tile is kMmaTR output rows x kTC columns (kMmaSteps k steps).
constexpr int kMmaTR = 8;                      // output rows per tile
constexpr int kMmaPix = kMmaTR * kTC;          // 256 pixels a tile
constexpr int kMmaSteps = kMmaPix / 16;        // 16 k steps a tile
constexpr int kMmaWR = 2 * kMmaTR + kK - 2;    // 21 window rows a channel
constexpr int kMmaMT = kCout / 16;             // 4 m tiles, all in a warp
constexpr int kMmaWarps = 7;                   // the MMA warps
constexpr int kMmaRows = kTapRows / kMmaWarps; // 3 filter rows (n tiles) each
constexpr int kMmaLoadWarps = 4;               // copy and build the planes
constexpr int kMmaMmaThreads = 32 * kMmaWarps;
constexpr int kMmaLoadThreads = 32 * kMmaLoadWarps;
constexpr int kMmaThreads = kMmaMmaThreads + kMmaLoadThreads;
// the cotangent tile: [64 channels][256 pixels] bf16, a 512-byte row of 32
// chunks of 8 pixels, chunk k of channel co at (k ^ (co & 7)): the 8 rows
// an ldmatrix phase reads (8 channels, one chunk) fall in 8 bank groups
constexpr int kMmaGBytes = kCout * kMmaPix * 2;          // 32768
// the input window: per (c, window row) two planes of 36 words, the even
// columns' at word 0 and the odd columns' at word 48 (16 banks apart: a
// fragment load's lanes read words 0..9 of each, conflict-free); word i
// of a plane holds its elements i and i + 1 (lower half first), so the
// pair of pixels (p, p + 1) of tap kx is word p + (kx >> 1) of plane kx & 1,
// 4-byte aligned for every tap
constexpr int kMmaPlaneO = 48;                 // words
constexpr int kMmaPlaneWords = 36;
constexpr int kMmaPitch = kMmaPlaneO + kMmaPlaneWords;   // 84 words a row
constexpr int kMmaWinRows = kCin * kMmaWR;               // 63
constexpr int kMmaWinBytes = kMmaWinRows * kMmaPitch * 4;
// the planes' source, copied asynchronously: per window row image columns
// 2*ox0 - 8 .. 2*ox0 + 71 as they are (ten 16-byte chunks), so that word
// m + 2 holds columns 2*ox0 - 4 + 2m and +1: odd-plane element m - 1 and
// even-plane element m
constexpr int kMmaRawWords = 40;
constexpr int kMmaRawBytes = kMmaWinRows * kMmaRawWords * 4;
constexpr int kMmaXWords = kMmaPlaneWords;               // m = 0..35
// rings: three cotangent tiles (one read by the MMA warps while the next
// two are copied), two planes (one read, one built), two sets of columns
// (one built into planes while the next is copied)
constexpr int kMmaGRing = 3;
constexpr int kMmaWinRing = 2;
constexpr int kMmaRawRing = 2;
static_assert(kMmaGRing == 3 && kMmaWinRing == 2 && kMmaRawRing == 2,
              "the load warps' waits assume these rings");
constexpr int kMmaSmem = kMmaGRing * kMmaGBytes + kMmaWinRing * kMmaWinBytes +
                         kMmaRawRing * kMmaRawBytes;
// promote the tensor cores' sums into float32 registers (__fadd_rn) every
// this many k steps (128 pixels)
constexpr int kMmaPromote = 8;
static_assert(kMmaRows * kMmaWarps == kTapRows, "3 filter rows a warp");
static_assert(kMmaPix % 16 == 0 && kTC % 16 == 0, "k steps within a row");
static_assert(kMmaTR >= kDwTR, "bad_shape counts the tiles of kDwTR rows");

// 16 bytes from global to shared memory, asynchronously; zero when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// The A fragments of an m16n8k16 product from shared memory: lane l gives
// the address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How a stage's input columns are copied: 16-byte chunks (W % 8 == 0 and
// x 16-byte aligned), 4-byte words (x 4-byte aligned), or loaded and stored
// by the threads.
enum MmaCopy { kCopyWords = 0, kCopy4 = 1, kCopy16 = 2 };

// Start copying the input columns of the window rows of tile t (kTileRows
// output rows) into raw (kMmaRawWords a row) as `copy` says (zero outside
// the image), with the kThreads threads from kFirst on.
template <int kThreads, int kTileRows, int kFirst = 0>
__device__ __forceinline__ void mma_x_async(
    const __nv_bfloat16* __restrict__ x, int H, int W, Tile t, int copy,
    unsigned char* raw) {
  constexpr int kWR = 2 * kTileRows + kK - 2;
  const int tid = threadIdx.x - kFirst;
  constexpr int kRows = kCin * kWR;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) +
                             (size_t)t.b * kCin * H * W;
  if (copy == kCopy16) {
    constexpr int kRowCopies = kMmaRawWords / 4;
    for (int i = tid; i < kRows * kRowCopies; i += kThreads) {
      const int row = i / kRowCopies;
      const int k = i % kRowCopies;
      const int c = row / kWR;
      const int gy = 2 * t.oy0 - 3 + row - c * kWR;
      const int gx = 2 * t.ox0 - 8 + 8 * k;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(raw + (row * kMmaRawWords + 4 * k) * 4,
                 in ? xb + ((size_t)c * H + gy) * W + gx : xb, in);
    }
  } else {
    for (int i = tid; i < kRows * kMmaXWords; i += kThreads) {
      const int row = i / kMmaXWords;
      const int m = i % kMmaXWords;
      const int c = row / kWR;
      const int gy = 2 * t.oy0 - 3 + row - c * kWR;
      const int gx = 2 * t.ox0 - 4 + 2 * m;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const unsigned short* p = xb + ((size_t)c * H + gy) * W + gx;
      unsigned char* dst = raw + (row * kMmaRawWords + m + 2) * 4;
      if (copy == kCopy4) {
        cp_async_f32(reinterpret_cast<float*>(dst),
                     reinterpret_cast<const float*>(in ? p : xb), in);
      } else {
        *reinterpret_cast<unsigned*>(dst) =
            in ? p[0] | (unsigned)p[1] << 16 : 0u;
      }
    }
  }
}

// Start copying tile t's cotangent into gs with the load warps: 64 x 32
// chunks of 8 pixels, by cp.async when every row of g is 16-byte aligned
// (vec), else loaded and stored (zero outside the image).  A load thread
// keeps one chunk position and steps over the channels.
__device__ __forceinline__ void mma_g_async(const __nv_bfloat16* __restrict__ g,
                                            int H, int W, Tile t, bool vec,
                                            unsigned char* gs) {
  constexpr int kChunks = kMmaPix / 8;          // of a channel
  constexpr int kStep = kMmaLoadThreads / kChunks;  // channels a pass
  static_assert(kMmaLoadThreads % kChunks == 0, "whole channels a pass");
  const int OH = H / 2;
  const int OW = W / 2;
  const size_t plane = (size_t)OH * OW;
  const int lt = threadIdx.x - kMmaMmaThreads;
  const int chunk = lt % kChunks;
  const int oy = t.oy0 + chunk / (kTC / 8);
  const int ox = t.ox0 + 8 * (chunk % (kTC / 8));
  const __nv_bfloat16* gb = g + (size_t)t.b * kCout * plane;
  const __nv_bfloat16* src = gb + (lt / kChunks) * plane + (size_t)oy * OW + ox;
#pragma unroll 4
  for (int co = lt / kChunks; co < kCout; co += kStep, src += kStep * plane) {
    unsigned char* dst = gs + co * (kMmaPix * 2) + 16 * (chunk ^ (co & 7));
    if (vec) {
      const bool in = oy < OH && ox < OW;
      cp_async16(dst, in ? src : gb, in);
    } else {
      unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = oy < OH && ox + e < OW
                   ? reinterpret_cast<const unsigned short*>(src)[e]
                   : 0;
      uint4 u;
      u.x = v[0] | (unsigned)v[1] << 16;
      u.y = v[2] | (unsigned)v[3] << 16;
      u.z = v[4] | (unsigned)v[5] << 16;
      u.w = v[6] | (unsigned)v[7] << 16;
      *reinterpret_cast<uint4*>(dst) = u;
    }
  }
}

// Build the two planes per window row in ws from the copied columns in raw
// with the load warps, two words of each plane an item: raw word m + 2
// holds odd-plane element m - 1 (low half) and even-plane element m (high
// half), so even word i is the high halves of raw words i + 2 and i + 3,
// odd word i the low halves of raw words i + 3 and i + 4.
__device__ __forceinline__ void mma_planes(const unsigned char* raw,
                                           unsigned char* ws) {
  constexpr int kItems = kMmaPlaneWords / 2;    // a row
  for (int i = threadIdx.x - kMmaMmaThreads; i < kMmaWinRows * kItems;
       i += kMmaLoadThreads) {
    const int row = i / kItems;
    const int m = 2 * (i % kItems);
    const uint2* r = reinterpret_cast<const uint2*>(
        raw + (row * kMmaRawWords + m + 2) * 4);
    const uint2 v0 = r[0];                       // raw words m + 2, m + 3
    const uint2 v1 = r[1];                       // m + 4, m + 5
    unsigned* w = reinterpret_cast<unsigned*>(ws) + row * kMmaPitch + m;
    *reinterpret_cast<uint2*>(w) =
        make_uint2(__byte_perm(v0.x, v0.y, 0x7632),
                   __byte_perm(v0.y, v1.x, 0x7632));
    *reinterpret_cast<uint2*>(w + kMmaPlaneO) =
        make_uint2(__byte_perm(v0.y, v1.x, 0x5410),
                   __byte_perm(v1.x, v1.y, 0x5410));
  }
}

// Named barriers between the MMA warps and the load warps: bar.sync waits
// for the barrier's count of threads, bar.arrive counts without waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// "tile j is staged" (the load warps arrive, the MMA warps wait) and "tile
// j is consumed" (the reverse), each alternating between two ids by j's
// parity, so that a barrier's next phase never starts before its last one
// ended
constexpr int kBarFull = 1;                    // ids 1, 2
constexpr int kBarEmpty = 3;                   // ids 3, 4

// One block per SM walks the tiles blockIdx.x + j gridDim.x.  The load
// warps copy tile j + 1's cotangent and columns while tile j's are built
// into planes, then hand tile j to the 7 MMA warps, which run the k steps
// back to back.
__global__ void __launch_bounds__(kMmaThreads, 1)
stem_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ g,
                   float* __restrict__ partials, int B, int H, int W,
                   bool vec, int copy) {
  extern __shared__ float4 smem4[];
  unsigned char* g_ring = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* win_ring = g_ring + kMmaGRing * kMmaGBytes;
  unsigned char* raw_ring = win_ring + kMmaWinRing * kMmaWinBytes;
  const Tiles tiles = tiles_of(B, H, W, kMmaTR);
  const int n = tiles.n > (int)blockIdx.x
                    ? (tiles.n - blockIdx.x + gridDim.x - 1) / gridDim.x
                    : 0;                         // this block's tiles
  auto tile_of = [&](int j) {
    return tile_at(tiles, blockIdx.x + j * gridDim.x, kMmaTR);
  };
  const int warp = threadIdx.x >> 5;

  if (warp >= kMmaWarps) {
    // the load warps: copy tile j + 1, build tile j's planes, hand it over
    auto copy_tile = [&](int j) {
      if (j < n) {
        const Tile t = tile_of(j);
        mma_g_async(g, H, W, t, vec, g_ring + (j % kMmaGRing) * kMmaGBytes);
        mma_x_async<kMmaLoadThreads, kMmaTR, kMmaMmaThreads>(
            x, H, W, t, copy, raw_ring + (j % kMmaRawRing) * kMmaRawBytes);
      }
      cp_async_commit();
    };
    copy_tile(0);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      // tile j - 2 is consumed: its cotangent buffer takes tile j + 1,
      // its planes buffer tile j's; and every load warp is done with tile
      // j - 1's columns, whose buffer takes tile j + 1's
      if (j >= 2)
        bar_sync(kBarEmpty + (j & 1), kMmaThreads);
      else
        bar_sync(5, kMmaLoadThreads);
      copy_tile(j + 1);
      cp_async_wait<1>();                        // tile j's copies
      bar_sync(5, kMmaLoadThreads);              // every load warp's copies
      mma_planes(raw_ring + (j % kMmaRawRing) * kMmaRawBytes,
                 win_ring + (j % kMmaWinRing) * kMmaWinBytes);
      bar_arrive(kBarFull + (j & 1), kMmaThreads);
    }
    cp_async_wait<0>();
    for (int j = n > 2 ? n - 2 : 0; j < n; ++j)
      bar_sync(kBarEmpty + (j & 1), kMmaThreads);
    return;
  }

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;                      // fragment row / column
  const int q = lane & 3;

  float tot[kMmaMT][kMmaRows][4];
  float acc[kMmaMT][kMmaRows][4];
#pragma unroll
  for (int m = 0; m < kMmaMT; ++m)
#pragma unroll
    for (int j = 0; j < kMmaRows; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[m][j][e] = acc[m][j][e] = 0.0f;

  // B fragment offsets (words) of this lane's tap kx = gq in a window row,
  // pixels 2q, 2q + 1 of a k step; and each n tile's window row base
  const int b_off = (gq & 1) * kMmaPlaneO + 2 * q + (gq >> 1);
  int b_row[kMmaRows];
#pragma unroll
  for (int j = 0; j < kMmaRows; ++j) {
    const int rho = kMmaRows * warp + j;         // c * 7 + ky
    b_row[j] = ((rho / kK) * kMmaWR + rho % kK) * kMmaPitch + b_off;
  }
  // A: ldmatrix row of this lane (channel within an m tile) and chunk
  const int a_co = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_chunk = lane >> 4;

  int since = 0;                                 // k steps since a promotion
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    bar_sync(kBarFull + (t & 1), kMmaThreads);
    const unsigned char* gs = g_ring + (t % kMmaGRing) * kMmaGBytes;
    const unsigned* ws = reinterpret_cast<const unsigned*>(
        win_ring + (t % kMmaWinRing) * kMmaWinBytes);
#pragma unroll 4
    for (int s = 0; s < kMmaSteps; ++s) {
      const int r = s / (kTC / 16);              // tile row
      const int px0 = (s % (kTC / 16)) * 16;     // first pixel of the step
      unsigned b[kMmaRows][2];
#pragma unroll
      for (int j = 0; j < kMmaRows; ++j) {
        const unsigned* p = ws + b_row[j] + 2 * r * kMmaPitch + px0;
        b[j][0] = p[0];
        b[j][1] = p[8];
      }
      const int chunk = (kTC / 8) * r + px0 / 8 + a_chunk;
#pragma unroll
      for (int m = 0; m < kMmaMT; ++m) {
        const int co = 16 * m + a_co;
        unsigned a[4];
        ldmatrix_x4(a, gs + co * (kMmaPix * 2) + 16 * (chunk ^ (co & 7)));
#pragma unroll
        for (int j = 0; j < kMmaRows; ++j) mma_bf16(acc[m][j], a, b[j][0],
                                                    b[j][1]);
      }
      if (++since == kMmaPromote) {
        since = 0;
#pragma unroll
        for (int m = 0; m < kMmaMT; ++m)
#pragma unroll
          for (int j = 0; j < kMmaRows; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[m][j][e] = __fadd_rn(tot[m][j][e], acc[m][j][e]);
              acc[m][j][e] = 0.0f;
            }
      }
    }
    bar_arrive(kBarEmpty + (t & 1), kMmaThreads);
  }

  // this block's [64, 147] partial: lane (gq, q) holds channels gq, gq + 8
  // of each m tile at taps kx = 2q, 2q + 1 of each of its filter rows
  float* out = partials + (size_t)blockIdx.x * kCout * kTaps;
#pragma unroll
  for (int m = 0; m < kMmaMT; ++m)
#pragma unroll
    for (int j = 0; j < kMmaRows; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 16 * m + gq + (e >> 1) * 8;
        const int kx = 2 * q + (e & 1);
        if (kx < kK)
          out[co * kTaps + (kMmaRows * warp + j) * kK + kx] =
              __fadd_rn(tot[m][j][e], acc[m][j][e]);
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
  // the most tiles: those of the fewest rows
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

std::atomic<unsigned> dw_mma_ready{0};

// The persistent grid of dW's partial pass for x's type: float32 one block
// per SM over tiles of kDwTR rows; bfloat16 (the tensor cores)
// one block per SM over tiles of kMmaTR rows.
template <typename T>
cudaError_t dw_blocks(int B, int H, int W, int* blocks) {
  return std::is_same<T, float>::value
             ? grid_blocks(B, H, W, kDwTR, 1, blocks)
             : grid_blocks(B, H, W, kMmaTR, 1, blocks);
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* partials,
                      float* dw, int B, int H, int W, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = dw_blocks<T>(B, H, W, &blocks);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) {
    err = opt_in_smem(stem_dw_partial_kernel, kDwSmem, dw_ready);
    if (err != cudaSuccess) return err;
    stem_dw_partial_kernel<<<blocks, kDwThreads, kDwSmem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), partials,
        B, H, W);
  } else {
    err = opt_in_smem(stem_dw_mma_kernel, kMmaSmem, dw_mma_ready);
    if (err != cudaSuccess) return err;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const bool vec = (W / 2) % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    const int copy = W % 8 == 0 && (xa & 15) == 0 ? kCopy16
                     : (xa & 3) == 0                ? kCopy4
                                                    : kCopyWords;
    stem_dw_mma_kernel<<<blocks, kMmaThreads, kMmaSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), partials, B, H, W, vec, copy);
  }
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
// (one [64, 147] sum per block of the larger of the two grids); 0 if the
// shape is refused.
int hnd_stem_dw_partials_size(int B, int H, int W) {
  int f32 = 0;
  int bf16 = 0;
  if (bad_shape(B, H, W) || dw_blocks<float>(B, H, W, &f32) != cudaSuccess ||
      dw_blocks<__nv_bfloat16>(B, H, W, &bf16) != cudaSuccess)
    return 0;
  return (f32 > bf16 ? f32 : bf16) * kCout * kTaps;
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
