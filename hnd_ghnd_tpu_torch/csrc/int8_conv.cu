// s8 x s8 -> s32 convolution for sm_90a: the integer convolutions of the
// int8 server tail (split/int8.py).
//
// Replaces the XLA op of hnd_ghnd_tpu/split/int8.py:_QuantKit._acc (:206,
// lax.conv_general_dilated of int8 codes by int8 weights with
// preferred_element_type=int32; XLA, not a Pallas kernel).  The plain
// version is ops/int8_conv.py:int8_conv_plain.
//
// x: NHWC int8 codes [B, H, W, C]; w: int8 weights [N, kh, kw, C/groups]
// (K contiguous); y: NHWC int32 [B, Ho, Wo, N].  Spatial padding pads the
// codes with 0, as lax zero-padding of the codes does (the int8 tail adds
// the zero point's share of the in-image taps itself).  Each output is the
// exact integer sum of its taps' products: int32 holds it for every shape
// of the tail (at most 3 x 3 x 512 taps of |127 x 128|, about 2^26).
//
// An implicit GEMM per group: M = B * Ho * Wo output pixels, N = C_out /
// groups, K = kh * kw * C / groups, with A[m, k] the code under tap k of
// pixel m (gathered from x as the tiles load, never written out) and B[k,
// n] = w[n, k].  A block computes a 128 x 128 tile of y over K in steps of
// 64 bytes; its 8 warps each hold a 64 x 32 tile of int32 accumulators in
// registers and run mma.sync m16n8k32 s8 (tensor cores), whose A fragment
// is four 4-byte K groups of a row and whose B fragment two of a column:
// both tiles are stored K-contiguous in shared memory, rows padded to 80
// bytes so that the 32-bit fragment loads of a warp hit 32 distinct banks.
// Two stages: cp.async brings step k + 1 (16 bytes a thread and row, with
// zero fill for rows past M, columns past N, taps outside the image and K
// past its end) while the warps multiply step k.  A 16-byte run of K stays
// within one tap when C / groups is a multiple of 16 (every conv of the
// trunk but the decoder's first, whose C is the bottleneck's 3); other
// shapes, and unaligned pointers, load byte by byte (same tiles).  K is
// padded to the 64-byte step with zero weights; the codes there are zero
// fill as well and are never read from x.
//
// Bound on the H100: the trunk's 46 convolutions at batch 8 on the
// 832x1344 bucket do 828 G multiply-adds, 0.84 ms at the 1,979 TOPS of
// dense int8, and read 1.6 GB of codes and write 5.8 GB of int32 sums,
// 2.2 ms at 3.35 TB/s: by bytes, mostly the int32 output (the float
// epilogue that consumes it is plain torch; fusing it here is later work).
// This first version keeps the design simple (mma.sync, not wgmma and
// TMA); PERF.md has its times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output pixels of a block tile
constexpr int kBN = 128;            // output channels of a block tile
constexpr int kBK = 64;             // bytes of K a stage
constexpr int kRow = kBK + 16;      // padded shared row, bytes
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kRow;

struct ConvShape {
  int B, H, W, C, N;
  int kh, kw, stride, pad, groups;
  int Ho, Wo, Cg, Ng, K;
  int M;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 inputs, s32 sums
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel (row of the A tile): where its taps start; not valid
// past M.
struct PixelRow {
  const int8_t* img;  // x at image b, channel offset of the group
  int hi0, wi0;       // top-left tap (may be outside the image)
  bool valid;
};

__device__ __forceinline__ PixelRow pixel_row(const ConvShape& s,
                                              const int8_t* x, int m,
                                              int group) {
  PixelRow r;
  r.valid = m < s.M;
  int mm = r.valid ? m : 0;
  int hw = s.Ho * s.Wo;
  int b = mm / hw;
  int rem = mm - b * hw;
  int ho = rem / s.Wo;
  int wo = rem - ho * s.Wo;
  r.img = x + static_cast<long long>(b) * s.H * s.W * s.C + group * s.Cg;
  r.hi0 = ho * s.stride - s.pad;
  r.wi0 = wo * s.stride - s.pad;
  return r;
}

// The code of A[row, k], or nullptr where it is zero (padding, K or M tail).
__device__ __forceinline__ const int8_t* tap_ptr(const ConvShape& s,
                                                 const PixelRow& r, int k) {
  if (!r.valid || k >= s.K) return nullptr;
  int tap = k / s.Cg;
  int c = k - tap * s.Cg;
  int ki = tap / s.kw;
  int kj = tap - ki * s.kw;
  int hi = r.hi0 + ki;
  int wi = r.wi0 + kj;
  if (hi < 0 || hi >= s.H || wi < 0 || wi >= s.W) return nullptr;
  return r.img + (static_cast<long long>(hi) * s.W + wi) * s.C + c;
}

// Stage the 16 bytes [k, k + 16) of A row `ra` and of the weights `wrow`
// of one output channel (nullptr past N) into shared memory.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const ConvShape& s,
                                           const PixelRow& ra,
                                           const int8_t* wrow, int k,
                                           int8_t* sa, int8_t* sb,
                                           const int8_t* any) {
  if (kVec) {
    const int8_t* pa = tap_ptr(s, ra, k);
    cp_async16(sa, pa ? pa : any, pa ? 16 : 0);
    bool wb = wrow != nullptr && k < s.K;
    cp_async16(sb, wb ? wrow + k : any, wb ? 16 : 0);
  } else {
    for (int j = 0; j < 16; ++j) {
      const int8_t* pa = tap_ptr(s, ra, k + j);
      sa[j] = pa ? *pa : static_cast<int8_t>(0);
      sb[j] = (wrow != nullptr && k + j < s.K) ? wrow[k + j]
                                               : static_cast<int8_t>(0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) int8_t smem[2 * kStageBytes];
  const int tid = threadIdx.x;
  const int group = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // loading: thread tid stages 16 bytes (chunk kc of the 64-byte step) of
  // rows r and r + 64 of both tiles
  const int kc = (tid & 3) * 16;
  const int r = tid >> 2;
  PixelRow ra[2];
  const int8_t* wrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ra[i] = pixel_row(s, x, m0 + r + 64 * i, group);
    int n = n0 + r + 64 * i;
    wrow[i] = n < s.Ng ? w + static_cast<long long>(group * s.Ng + n) * s.K
                       : nullptr;
  }
  auto load_stage = [&](int stage, int k0) {
    int8_t* base = smem + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int row = r + 64 * i;
      load_chunk<kVec>(s, ra[i], wrow[i], k0 + kc, base + row * kRow + kc,
                       base + (kBM + row) * kRow + kc, x);
    }
  };

  // computing: warp (wm, wn) owns rows 64 wm .. +64, columns 32 wn .. +32
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int g = lane >> 2;  // groupID of the fragment layouts
  const int t = lane & 3;   // thread in group
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (s.K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load_stage((step + 1) & 1, (step + 1) * kBK);
    cp_async_commit();
    cp_async_wait_one();  // this step's group has landed
    __syncthreads();
    const int8_t* sa = smem + (step & 1) * kStageBytes;
    const int8_t* sb = sa + kBM * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = sa + (wm * 64 + i * 16 + g) * kRow + kk + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sb + (wn * 32 + j * 8 + g) * kRow + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // the next step's loads overwrite this buffer
  }

  // accumulator (i, j, e): row 16 i + g + 8 (e >> 1), column 8 j + 2 t +
  // (e & 1) of the warp's tile
  const bool pairs = (s.N % 2 == 0) && ((group * s.Ng) % 2 == 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= s.M) continue;
      int32_t* yrow = y + static_cast<long long>(m) * s.N + group * s.Ng;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int n = n0 + wn * 32 + j * 8 + 2 * t;
        int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && n + 1 < s.Ng) {
          *reinterpret_cast<int2*>(yrow + n) = make_int2(v0, v1);
        } else {
          if (n < s.Ng) yrow[n] = v0;
          if (n + 1 < s.Ng) yrow[n + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// y = conv(x, w) in int32, see above.  x: [B, H, W, C] int8, w: [N, kh, kw,
// C / groups] int8, y: [B, Ho, Wo, N] int32, all contiguous on the device;
// Ho = (H + 2 pad - kh) / stride + 1, likewise Wo.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
int hnd_int8_conv(const int8_t* x, const int8_t* w, int32_t* y, int B, int H,
                  int W, int C, int N, int kh, int kw, int stride, int pad,
                  int groups, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || groups <= 0 || C % groups || N % groups)
    return cudaErrorInvalidValue;
  ConvShape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.N = N;
  s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad; s.groups = groups;
  s.Ho = (H + 2 * pad - kh) / stride + 1;
  s.Wo = (W + 2 * pad - kw) / stride + 1;
  s.Cg = C / groups;
  s.Ng = N / groups;
  s.K = kh * kw * s.Cg;
  long long m = static_cast<long long>(B) * s.Ho * s.Wo;
  if (H + 2 * pad < kh || W + 2 * pad < kw || m >= (1LL << 31))
    return cudaErrorInvalidValue;
  s.M = static_cast<int>(m);
  dim3 grid(static_cast<unsigned>((s.M + kBM - 1) / kBM),
            static_cast<unsigned>((s.Ng + kBN - 1) / kBN),
            static_cast<unsigned>(groups));
  if (grid.x > 0x7fffffffu || grid.z > 65535u) return cudaErrorInvalidValue;
  bool vec = s.Cg % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(x, w, y, s);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(x, w, y, s);
  return cudaGetLastError();
}

}  // extern "C"
