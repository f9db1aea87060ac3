// s8 x s8 -> s32 convolution for sm_90a with the int8 server tail's
// requantization fused into its store: the integer convolutions of
// split/int8.py.
//
// Replaces the XLA op of hnd_ghnd_tpu/split/int8.py:_QuantKit._acc (:206,
// lax.conv_general_dilated of int8 codes by int8 weights with
// preferred_element_type=int32; XLA, not a Pallas kernel) and the float32
// ops that JAX's walk applies to its sums (:214-238).  The plain versions
// are ops/int8_conv.py:int8_conv_plain and int8_conv_requant_plain.
//
// x: NHWC int8 codes [B, H, W, C]; w: int8 weights [N, kh, kw, C/groups]
// (K contiguous).  Spatial padding pads the codes with 0, as lax
// zero-padding of the codes does (the zero point's share of the in-image
// taps comes in through the epilogue).  Each sum is the exact integer sum of
// its taps' products: int32 holds it for every shape of the tail (at most
// 3 x 3 x 512 taps of |127 x 128|, about 2^26).
//
// The epilogue (Epilogue below) reads the sums from the accumulator
// registers and writes one of
//   int32     the sums (the bit-exact yardstick; not on the tail's path);
//   float     y = fl(fl(fl(acc) + zp) * sc[n]) + b[n], float32 NHWC (the
//             downsample, read by its block's last conv);
//   site      y, then ReLU where the site follows one, then the site's
//             codes: rint(y / su) clamped to [0, 255] minus 128 (zero point
//             128), or rint(y / s) clamped to [-127, 127]; int8 NHWC;
//   residual  relu(y + id) requantized as an unsigned site, where id is the
//             downsample's float32 or the identity's codes dequantized,
//             fl(fl(q + zp) * s);
// and, where asked, the dequantized codes fl(fl(q + zp) * s) as a float32
// NCHW feature for the FPN.  zp is the constant zero point share [N]
// without padding or the border map [Ho, Wo, N] with it.  Every float step
// is one IEEE operation in the JAX walk's order (__fadd_rn, __fmul_rn: nvcc
// would contract a * b + c into an FMA; the site's division correctly
// rounded, see SiteScale), NaN goes to code 0 as torch.clamp and
// nan_to_num take it, +-inf to the range's ends; so the codes equal the
// plain version's, and the CPU's, bit for bit.
//
// Two main loops, chosen by the wrapper from the shape before the launch:
//
// wgmma (groups 1, C a multiple of 64, C_out of 128, stride 1 or 2,
// 16-byte aligned codes and weights: 45 of the trunk's 46 convs).  A block
// computes a 128 x 128 tile: 128 output pixels, a rectangle of TH rows x TW
// columns of one image (TW from 8 to 128, the one that wastes the fewest
// pixels on the ragged edge), by 128 output channels.  K runs tap by tap in
// chunks of BK bytes of channels (128 where C allows, else 64; the TMA
// swizzle matches the chunk).  One producer warp issues TMA loads into a
// ring of mbarrier-guarded stages: for tap (ki, kj) and chunk c0 the A tile
// is one box of a 4-D tensor map over the codes [C, W, H, B] at (c0, wo0 s
// - p + kj, ho0 s - p + ki, b); a stride-2 conv reads through one map per
// (row, column) parity, whose W and H run over every second pixel, so the
// box stays dense.  TMA fills coordinates outside the image, negative ones
// included, with 0: the zero padding.  The B tile is a box of a 2-D map over
// the weights [N, K].  Two consumer warpgroups each run wgmma m64n128k32
// s8 on 64 of the rows, both operands K-major in shared memory (the only
// layout 8-bit wgmma takes, and the one the codes and weights already have).
//
// mma.sync (everything else: dec0, whose C is the bottleneck's 3, grouped
// and unaligned convs).  An implicit GEMM on 128 x 128 tiles over 64-byte
// K steps, 8 warps of mma.sync m16n8k32 s8, cp.async double buffering,
// byte loads where C / groups is not a multiple of 16.
//
// The epilogue of the wgmma path: both warpgroups park the 128 x 128 sums
// in shared memory (the stage buffers, free once the last wgmma is done);
// then each thread loops over quads (4 channels of a pixel: one vector
// store, the channels' scale, bias and zero point share loaded once a tile,
// 4 pixels' border map and identity loads in flight together), and a
// stage output's NCHW feature goes out by channel, 32 pixels a warp.
//
// Bound on the H100, the trunk's 46 convs at batch 8 on 832x1344: 828 G
// multiply-adds, 0.84 ms at 1,979 TOPS of dense int8.  Fused, they read
// 1.6 GB of codes (and the residuals' identities) and write int8 codes,
// the downsamples' float32 and the four NCHW float32 features: 1.64 ms at
// 3.35 TB/s, bound by bytes (1.31 without the features).  The int32 mode
// writes 5.8 GB of sums (2.2 ms).  What holds it back (PERF.md): the int32
// mode runs about 12% behind torch._int_mm; the fused walk takes about 1.7
// times the int32 walk, at ~21% of its bound: its epilogue is bound by
// instruction issue (a division and several conversions an output, 16
// consumer warps an SM), not by bytes, and is not overlapped with the
// tensor cores, since a block computes one tile and then stores it.  The
// next step is persistent blocks whose epilogue of one tile overlaps the
// main loop of the next.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The fused epilogue
// ---------------------------------------------------------------------------

enum Mode { kInt32 = 0, kSite = 1, kFloat = 2, kResidual = 3 };

struct ConvShape {
  int B, H, W, C, N;
  int kh, kw, stride, pad, groups;
  int Ho, Wo, Cg, Ng, K;
  int M;
};

struct Epilogue {
  int mode;
  void* out;                // NHWC [B, Ho, Wo, N]: int32, int8 or float32
  const float* zp;          // [N] zero point's share without padding, or null
  const float* zp_map;      // [Ho, Wo, N] border map with padding, or null
  const float* scale;       // [N] s_in sw[n]
  const float* bias;        // [N]
  const float* site_scale;  // the output site's s or su (one float)
  int relu;                 // ReLU before the site's codes
  int unsigned_site;        // codes over [0, 255] - 128, zero point 128
  const int8_t* id_codes;   // residual identity as NHWC codes, or null
  const float* id_scale;    // its scale (one float)
  float id_zp;              // its zero point, 0 or 128
  const float* id_float;    // residual identity as NHWC float32, or null
  float* feat;              // NCHW float32 [B, N, Ho, Wo] features, or null
};

// One output pixel of the tile: its linear index, position and validity.
struct Pixel {
  long long p;   // (b Ho + ho) Wo + wo
  int hw;        // ho Wo + wo
  int b, ho, wo;
  bool valid;
};

__device__ __forceinline__ float relu_keep_nan(float y) {
  return y < 0.f ? 0.f : y;  // torch.relu: NaN stays NaN
}

// A site's scale s and RN(1 / s).  The code of y needs the IEEE quotient
// RN(y / s).  __fdiv_rn gets it with a check for special operands that
// branches at every output, and the branches keep the compiler from
// interleaving the outputs' arithmetic (the fused walk took 10.7 ms with
// it, 7.8 without; PERF.md).  Where s is in [2^-60, 2^60] the kernel
// computes it without a branch (Markstein's correction): q0 = RN(y rs)
// is within 2 ulps of y / s, one correction q1 = RN(q0 + RN(y - q0 s) rs)
// brings it within an ulp, and then, rs being RN(1 / s), the remainder
// y - q1 s is exact and q2 = RN(q1 + (y - q1 s) rs) = RN(y / s).  The
// range of s keeps every remainder that can decide a code (|y / s| >=
// 0.5) out of the subnormals; NaN and +-inf quotients pass through q0.
struct SiteScale {
  float s, rs;
  bool fast;  // s in [2^-60, 2^60]: the branch-free quotient
};

__device__ __forceinline__ SiteScale site_scale(float s) {
  SiteScale d;
  d.s = s;
  d.rs = __frcp_rn(s);
  d.fast = s >= 0x1p-60f && s <= 0x1p60f;
  return d;
}

template <bool kFast>
__device__ __forceinline__ float quotient(float y, const SiteScale& d) {
  if (!kFast) return __fdiv_rn(y, d.s);
  const float q0 = __fmul_rn(y, d.rs);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, d.s, y), d.rs, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-q1, d.s, y), d.rs, q1);
  return fabsf(q0) < __int_as_float(0x7f800000) ? q2 : q0;
}

// A site's code of y: rint(y / s), clamped; NaN -> 0 (torch.clamp keeps
// NaN, nan_to_num makes it 0); +-inf clamp to the ends.  The quotient is
// rounded half to even to an integer that saturates at the int range
// (__float2int_rn), which the clamp then takes as it takes the float.
template <bool kFast>
__device__ __forceinline__ int site_code(float y, const SiteScale& d,
                                         bool uns) {
  const float x = quotient<kFast>(y, d);
  if (x != x) return 0;
  const int r = __float2int_rn(x);
  if (uns) return min(max(r, 0), 255) - 128;
  return min(max(r, -127), 127);
}

// The epilogue's arithmetic, shared by both main loops.  y = fl(fl(fl(acc)
// + zp) * sc) + b, where zp is 0 for a signed input (fl(x + 0) = x).
__device__ __forceinline__ float affine(int acc, float zp, float sc, float b) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__int2float_rn(acc), zp), sc), b);
}

// (q + zp) s, a code dequantized: an identity, or a stage's feature.
__device__ __forceinline__ float dequant(float q, float zp, float s) {
  return __fmul_rn(__fadd_rn(q, zp), s);
}

// The site's code of y (site and residual modes): + the identity (id),
// ReLU, quantize.
template <bool kFast>
__device__ __forceinline__ int site_value(const Epilogue& e, float y,
                                          float id, const SiteScale& d) {
  if (e.mode == kResidual) y = __fadd_rn(y, id);
  if (e.relu) y = relu_keep_nan(y);
  return site_code<kFast>(y, d, e.unsigned_site != 0);
}

__device__ __forceinline__ float feature_value(const Epilogue& e, int q,
                                               float s_out) {
  return dequant(static_cast<float>(q), e.unsigned_site ? 128.f : 0.f,
                 s_out);
}

// affine() of channel n of pixel px, its operands loaded one by one (the
// mma.sync path).
__device__ __forceinline__ float affine_at(const Epilogue& e, int acc,
                                           const Pixel& px, int N, int n) {
  float zp = 0.f;
  if (e.zp != nullptr)
    zp = __ldg(e.zp + n);
  else if (e.zp_map != nullptr)
    zp = __ldg(e.zp_map + static_cast<long long>(px.hw) * N + n);
  return affine(acc, zp, __ldg(e.scale + n), __ldg(e.bias + n));
}

__device__ __forceinline__ int code_at(const Epilogue& e, int acc,
                                       const Pixel& px, int N, int n,
                                       const SiteScale& d) {
  float id = 0.f;
  if (e.mode == kResidual) {
    const long long i = px.p * N + n;
    id = e.id_codes != nullptr
             ? dequant(static_cast<float>(e.id_codes[i]), e.id_zp,
                       __ldg(e.id_scale))
             : e.id_float[i];
  }
  const float y = affine_at(e, acc, px, N, n);
  return d.fast ? site_value<true>(e, y, id, d)
                : site_value<false>(e, y, id, d);
}

__device__ __forceinline__ void store_feature(const Epilogue& e,
                                              const ConvShape& s,
                                              const Pixel& px, int n, int q,
                                              float s_out) {
  e.feat[((static_cast<long long>(px.b) * s.N + n) * s.Ho + px.ho) * s.Wo +
         px.wo] = feature_value(e, q, s_out);
}

// Channels n and n + 1 of pixel px (n + 1 only where `two`), from the sums
// a0 and a1; `vec` where the pair may be stored as one vector.  Not
// inlined: the mma.sync kernel calls it for 32 pairs, and 32 inlined copies
// of every mode's arithmetic would not fit the instruction cache.
__device__ __noinline__ void store_pair(const Epilogue& e,
                                           const ConvShape& s,
                                           const Pixel& px, int n, int a0,
                                           int a1, bool two, bool vec) {
  const int N = s.N;
  const long long i = px.p * N + n;
  if (e.mode == kInt32) {
    int32_t* y = static_cast<int32_t*>(e.out) + i;
    if (two && vec) {
      *reinterpret_cast<int2*>(y) = make_int2(a0, a1);
    } else {
      y[0] = a0;
      if (two) y[1] = a1;
    }
    return;
  }
  if (e.mode == kFloat) {
    float* y = static_cast<float*>(e.out) + i;
    float v0 = affine_at(e, a0, px, N, n);
    if (two) {
      float v1 = affine_at(e, a1, px, N, n + 1);
      if (vec) {
        *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
      } else {
        y[0] = v0;
        y[1] = v1;
      }
    } else {
      y[0] = v0;
    }
    return;
  }
  const float s_out = __ldg(e.site_scale);
  const SiteScale d = site_scale(s_out);
  int8_t* y = static_cast<int8_t*>(e.out) + i;
  int q0 = code_at(e, a0, px, N, n, d);
  int q1 = two ? code_at(e, a1, px, N, n + 1, d) : 0;
  if (two && vec) {
    *reinterpret_cast<char2*>(y) = make_char2(static_cast<char>(q0),
                                              static_cast<char>(q1));
  } else {
    y[0] = static_cast<int8_t>(q0);
    if (two) y[1] = static_cast<int8_t>(q1);
  }
  if (e.feat != nullptr) {
    store_feature(e, s, px, n, q0, s_out);
    if (two) store_feature(e, s, px, n + 1, q1, s_out);
  }
}

// The wgmma path's epilogue works on quads: 4 channels n .. n + 3 of one
// pixel (C_out is a multiple of 128 and the outputs are fresh allocations,
// so a quad's store is one vector).  A thread keeps its quad's channels for
// the whole tile, so their scale, bias and zero point share load once; a
// pixel's border map and identity load ahead of the arithmetic, several
// pixels at a time.
struct QuadConsts {
  float sc[4], bi[4], zc[4];  // zc: the constant zero point share, or 0
};

struct QuadIn {
  float zm[4];  // border map
  float id[4];  // the identity: float32, or its codes as floats
};

__device__ __forceinline__ void load4(float* dst, const float* p, bool vec) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ void quad_in(const Epilogue& e, const ConvShape& s,
                                        const Pixel& px, int n, bool vec_map,
                                        bool vec_id, QuadIn& in) {
  const long long i = px.p * s.N + n;
  if (e.zp_map != nullptr)
    load4(in.zm, e.zp_map + static_cast<long long>(px.hw) * s.N + n,
          vec_map);
  if (e.mode != kResidual) return;
  if (e.id_codes != nullptr) {
    if (vec_id) {
      const char4 q = *reinterpret_cast<const char4*>(e.id_codes + i);
      in.id[0] = q.x; in.id[1] = q.y; in.id[2] = q.z; in.id[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) in.id[k] = e.id_codes[i + k];
    }
  } else {
    load4(in.id, e.id_float + i, vec_id);
  }
}

// The quad's outputs from its sums a; the features' values go to f[4].
template <bool kFast>
__device__ __forceinline__ void quad_out(const Epilogue& e,
                                         const ConvShape& s, const Pixel& px,
                                         int n, const int4& a4,
                                         const QuadConsts& qc,
                                         const QuadIn& in, const SiteScale& d,
                                         float s_id, float* f) {
  const long long i = px.p * s.N + n;
  if (e.mode == kInt32) {
    *reinterpret_cast<int4*>(static_cast<int32_t*>(e.out) + i) = a4;
    return;
  }
  const int a[4] = {a4.x, a4.y, a4.z, a4.w};
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = affine(a[k], e.zp_map != nullptr ? in.zm[k] : qc.zc[k], qc.sc[k],
                  qc.bi[k]);
  if (e.mode == kFloat) {
    *reinterpret_cast<float4*>(static_cast<float*>(e.out) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  int q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float id = 0.f;
    if (e.mode == kResidual)
      id = e.id_codes != nullptr ? dequant(in.id[k], e.id_zp, s_id)
                                 : in.id[k];
    q[k] = site_value<kFast>(e, v[k], id, d);
  }
  if (e.feat != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = feature_value(e, q[k], d.s);
  }
  *reinterpret_cast<char4*>(static_cast<int8_t*>(e.out) + i) =
      make_char4(static_cast<char>(q[0]), static_cast<char>(q[1]),
                 static_cast<char>(q[2]), static_cast<char>(q[3]));
}

__device__ __forceinline__ Pixel linear_pixel(const ConvShape& s, int m) {
  Pixel px;
  px.valid = m < s.M;
  int mm = px.valid ? m : 0;
  int hw = s.Ho * s.Wo;
  px.b = mm / hw;
  px.hw = mm - px.b * hw;
  px.ho = px.hw / s.Wo;
  px.wo = px.hw - px.ho * s.Wo;
  px.p = mm;
  return px;
}

// ---------------------------------------------------------------------------
// mma.sync main loop (any shape)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // output pixels of a block tile
constexpr int kBN = 128;            // output channels of a block tile
constexpr int kBK = 64;             // bytes of K a stage
constexpr int kRow = kBK + 16;      // padded shared row, bytes
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kRow;

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
  Pixel px = linear_pixel(s, m);
  PixelRow r;
  r.valid = px.valid;
  r.img = x + static_cast<long long>(px.b) * s.H * s.W * s.C + group * s.Cg;
  r.hi0 = px.ho * s.stride - s.pad;
  r.wi0 = px.wo * s.stride - s.pad;
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
int8_conv_mma_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, ConvShape s, Epilogue e) {
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
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

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

  // accumulator (i, j, q): row 16 i + g + 8 (q >> 1), column 8 j + 2 t +
  // (q & 1) of the warp's tile
  const int cofs = group * s.Ng;
  const bool vec = (s.N % 2 == 0) && (cofs % 2 == 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Pixel px = linear_pixel(s, m0 + wm * 64 + i * 16 + g + 8 * h);
      if (!px.valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= s.Ng) continue;
        store_pair(e, s, px, cofs + n, acc[i][j][2 * h], acc[i][j][2 * h + 1],
                   n + 1 < s.Ng, vec);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma + TMA main loop (groups 1, C % 64 == 0, N % 128 == 0, stride 1, 2)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kWgTile = 128;     // pixels and channels of a block tile
// two blocks on an SM, so that one's epilogue overlaps the other's main
// loop (shared memory: 3 stages of 32 KB, or 4 of 16 KB, a block)
constexpr int kWgBlocksPerSM = 2;

struct TmaMaps {
  CUtensorMap a[4];  // codes, one map per (row, column) parity of a stride
  CUtensorMap w;     // weights [N, K]
};

struct TileShape {
  int tw, th;        // the pixel rectangle: th rows of tw columns
  int tw_log2;
  int tiles_w, tiles_h, tiles_n;
  int steps;         // K steps: kh kw C / BK
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const uint32_t a = smem_u32(bar);
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared memory descriptor of a K-major tile whose rows are kSwizzle bytes
// (128 or 64), swizzled as TMA wrote it: 8-row groups kSwizzle x 8 apart.
template <int kSwizzle>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;                       // leading offset (unused)
  d |= uint64_t((8 * kSwizzle) >> 4) << 32;     // stride between 8 rows
  d |= uint64_t(kSwizzle == 128 ? 1 : 2) << 62;  // 128B or 64B swizzle
  return d;
}

#define HND_R8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] += A (64 x 32, K-major, shared) * B (32 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : HND_R8(0), HND_R8(8), HND_R8(16), HND_R8(24), HND_R8(32), HND_R8(40),
        HND_R8(48), HND_R8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef HND_R8

constexpr int kCRow = kWgTile + 4;  // ints of a row of the staged C tile

// The tile's pixel r (of 128): row r / tw, column r % tw of the rectangle.
__device__ __forceinline__ Pixel tile_pixel(const ConvShape& s,
                                            const TileShape& t, int b,
                                            int ho0, int wo0, int r) {
  Pixel px;
  px.b = b;
  px.ho = ho0 + (r >> t.tw_log2);
  px.wo = wo0 + (r & (t.tw - 1));
  px.valid = px.ho < s.Ho && px.wo < s.Wo;
  px.hw = px.ho * s.Wo + px.wo;
  px.p = static_cast<long long>(b) * s.Ho * s.Wo + px.hw;
  return px;
}

// The quads of a tile: thread tid's 4 channels n0 + c .. and its pixels
// r0, r0 + 8, .. of the C tile ct; the features' values go back into ct.
template <bool kFast>
__device__ __forceinline__ void quad_loop(const Epilogue& e,
                                          const ConvShape& s,
                                          const TileShape& t,
                                          const SiteScale& d, int b, int ho0,
                                          int wo0, int n0, int tid, int* ct) {
  const float s_id = e.id_codes != nullptr ? __ldg(e.id_scale) : 0.f;
  const int c = (tid & 31) * 4;  // the thread's quad: channels n0 + c ..
  const int r0 = tid >> 5;       // and pixels r0, r0 + 8, .. of the tile
  QuadConsts qc;
  if (e.mode != kInt32) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qc.sc[k] = __ldg(e.scale + n0 + c + k);
      qc.bi[k] = __ldg(e.bias + n0 + c + k);
      qc.zc[k] = e.zp != nullptr ? __ldg(e.zp + n0 + c + k) : 0.f;
    }
  }
  const bool vec_map = (reinterpret_cast<uintptr_t>(e.zp_map) & 15) == 0;
  const bool vec_id =
      e.id_codes != nullptr
          ? (reinterpret_cast<uintptr_t>(e.id_codes) & 3) == 0
          : (reinterpret_cast<uintptr_t>(e.id_float) & 15) == 0;
  constexpr int kBatch = 4;  // pixels whose loads are in flight together
#pragma unroll 1
  for (int u = 0; u < kWgTile / 8; u += kBatch) {
    Pixel px[kBatch];
    int4 a[kBatch];
    QuadIn in[kBatch];
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int r = r0 + 8 * (u + v);
      px[v] = tile_pixel(s, t, b, ho0, wo0, r);
      a[v] = *reinterpret_cast<const int4*>(ct + r * kCRow + c);
      if (px[v].valid) quad_in(e, s, px[v], n0 + c, vec_map, vec_id, in[v]);
    }
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      if (!px[v].valid) continue;
      float f[4];
      quad_out<kFast>(e, s, px[v], n0 + c, a[v], qc, in[v], d, s_id, f);
      if (e.feat != nullptr)
        *reinterpret_cast<float4*>(ct + (r0 + 8 * (u + v)) * kCRow + c) =
            make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

template <int kBKw, int kStages>
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSM)
int8_conv_wgmma_kernel(const __grid_constant__ TmaMaps maps, ConvShape s,
                       TileShape t, Epilogue e) {
  constexpr int kTileBytes = kWgTile * kBKw;  // one operand's stage
  __shared__ uint64_t full[kStages], empty[kStages];
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + kStages * kTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bid = blockIdx.x;
  const int n0 = (bid % t.tiles_n) * kWgTile;
  int mt = bid / t.tiles_n;
  const int b = mt / (t.tiles_h * t.tiles_w);
  mt -= b * t.tiles_h * t.tiles_w;
  const int ho0 = (mt / t.tiles_w) * t.th;
  const int wo0 = (mt % t.tiles_w) * t.tw;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = s.C / kBKw;
  if (warp == 8) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < t.steps; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
        const int tap = i / chunks;
        const int c0 = (i - tap * chunks) * kBKw;
        const int ki = tap / s.kw;
        const int kj = tap - ki * s.kw;
        // input row ho s - p + ki = s (ho + off) + parity
        const int dh = ki - s.pad, dw = kj - s.pad;
        const int offh = dh >= 0 ? dh / s.stride
                                 : -((-dh + s.stride - 1) / s.stride);
        const int offw = dw >= 0 ? dw / s.stride
                                 : -((-dw + s.stride - 1) / s.stride);
        const int par = (dh - offh * s.stride) * s.stride +
                        (dw - offw * s.stride);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_4d(sa + st * kTileBytes, &maps.a[par], &full[st], c0,
                    wo0 + offw, ho0 + offh, b);
        tma_load_2d(sb + st * kTileBytes, &maps.w, &full[st],
                    tap * s.C + c0, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int i = 0; i < t.steps; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint64_t da =
        smem_desc<kBKw>(sa + st * kTileBytes + wg * 64 * kBKw);
    const uint64_t db = smem_desc<kBKw>(sb + st * kTileBytes);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBKw / 32; ++kk)
      wgmma_m64n128k32(d, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this step's products in flight; the last step's are done, so
    // its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // The epilogue.  Both consumer warpgroups are past their last wgmma (and
  // every load has landed), so the stage buffers take the C tile, [128
  // pixels][128 channels] of int32; then each thread stores 4 channels of
  // a pixel at a time (a warp a pixel's 128 channels), and the features
  // go out by channel (a warp 32 pixels of one channel).  A loop, not 64
  // inlined copies of the arithmetic.
  // accumulator d[4 j + q]: row 16 (warp % 4) + lane / 4 + 8 (q >> 1) of
  // the warpgroup's 64, column 8 j + 2 (lane % 4) + (q & 1)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  int* ct = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ct[(wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * (q >> 1)) * kCRow +
         j * 8 + 2 * (lane & 3) + (q & 1)] = d[4 * j + q];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const bool sites = e.mode == kSite || e.mode == kResidual;
  const SiteScale site = site_scale(sites ? __ldg(e.site_scale) : 1.f);
  if (site.fast)
    quad_loop<true>(e, s, t, site, b, ho0, wo0, n0, tid, ct);
  else
    quad_loop<false>(e, s, t, site, b, ho0, wo0, n0, tid, ct);
  if (e.feat == nullptr) return;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int it = tid; it < kWgTile * kWgTile; it += 256) {
    const int ch = it >> 7;
    const int r = it & (kWgTile - 1);
    const Pixel px = tile_pixel(s, t, b, ho0, wo0, r);
    if (px.valid)
      e.feat[((static_cast<long long>(b) * s.N + n0 + ch) * s.Ho + px.ho) *
                 s.Wo + px.wo] = __int_as_float(ct[r * kCRow + ch]);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The rectangle of 128 output pixels that wastes the fewest on the edges
// (the widest among equals).
void pick_tile(int Ho, int Wo, int* tw, int* th) {
  long long best = -1;
  for (int w = 128; w >= 8; w /= 2) {
    int h = kWgTile / w;
    long long cost = static_cast<long long>((Wo + w - 1) / w) * w *
                     ((Ho + h - 1) / h) * h;
    if (best < 0 || cost < best) {
      best = cost;
      *tw = w;
      *th = h;
    }
  }
}

bool wgmma_takes(const ConvShape& s, const int8_t* x, const int8_t* w) {
  return s.groups == 1 && s.C % 64 == 0 && s.N % kWgTile == 0 &&
         (s.stride == 1 || s.stride == 2) && s.H >= s.stride &&
         s.W >= s.stride && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <int kBKw, int kStages>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* w, const ConvShape& s,
                         const Epilogue& e, cudaStream_t st) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = kBKw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  TileShape t;
  pick_tile(s.Ho, s.Wo, &t.tw, &t.th);
  for (t.tw_log2 = 0; (1 << t.tw_log2) < t.tw; ++t.tw_log2) {
  }
  t.tiles_w = (s.Wo + t.tw - 1) / t.tw;
  t.tiles_h = (s.Ho + t.th - 1) / t.th;
  t.tiles_n = s.N / kWgTile;
  t.steps = s.kh * s.kw * (s.C / kBKw);
  TmaMaps maps;
  const int sd = s.stride;
  for (int hp = 0; hp < sd; ++hp) {
    for (int wp = 0; wp < sd; ++wp) {
      cuuint64_t dims[4] = {
          static_cast<cuuint64_t>(s.C),
          static_cast<cuuint64_t>((s.W - wp + sd - 1) / sd),
          static_cast<cuuint64_t>((s.H - hp + sd - 1) / sd),
          static_cast<cuuint64_t>(s.B)};
      cuuint64_t strides[3] = {
          static_cast<cuuint64_t>(sd) * s.C,
          static_cast<cuuint64_t>(sd) * s.W * s.C,
          static_cast<cuuint64_t>(s.H) * s.W * s.C};
      cuuint32_t box[4] = {static_cast<cuuint32_t>(kBKw),
                           static_cast<cuuint32_t>(t.tw),
                           static_cast<cuuint32_t>(t.th), 1};
      cuuint32_t ones[4] = {1, 1, 1, 1};
      void* base = const_cast<int8_t*>(
          x + (static_cast<long long>(hp) * s.W + wp) * s.C);
      if (enc(&maps.a[hp * sd + wp], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base,
              dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
  }
  for (int i = sd * sd; i < 4; ++i) maps.a[i] = maps.a[0];
  {
    cuuint64_t dims[2] = {static_cast<cuuint64_t>(s.K),
                          static_cast<cuuint64_t>(s.N)};
    cuuint64_t strides[1] = {static_cast<cuuint64_t>(s.K)};
    cuuint32_t box[2] = {static_cast<cuuint32_t>(kBKw),
                         static_cast<cuuint32_t>(kWgTile)};
    cuuint32_t ones[2] = {1, 1};
    if (enc(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<int8_t*>(w), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const long long blocks = static_cast<long long>(s.B) * t.tiles_h *
                           t.tiles_w * t.tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int stages = 2 * kStages * kWgTile * kBKw;
  const int ctile = kWgTile * kCRow * 4;
  const int smem = (stages > ctile ? stages : ctile) + 1024;
  auto kernel = int8_conv_wgmma_kernel<kBKw, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, st>>>(maps, s, t,
                                                                   e);
  return cudaGetLastError();
}

}  // namespace

namespace {

cudaError_t make_shape(int B, int H, int W, int C, int N, int kh, int kw,
                       int stride, int pad, int groups, ConvShape* out) {
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
  if (H + 2 * pad < kh || W + 2 * pad < kw || m >= (1LL << 31) ||
      m * N >= (1LL << 40))
    return cudaErrorInvalidValue;
  s.M = static_cast<int>(m);
  *out = s;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The convolution with its epilogue (see above).  x: [B, H, W, C] int8, w:
// [N, kh, kw, C / groups] int8, contiguous on the device; `path` the main
// loop the caller chose by shape (1: wgmma + TMA, 0: mma.sync, as
// ops/int8_conv.py:template_for; a path that cannot take the shape is
// refused, never replaced); mode 0 int32, 1 site, 2
// float, 3 residual; the epilogue's tensors as described in Epilogue,
// null where unused.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape or path it does not take).
int hnd_int8_conv_fused(const int8_t* x, const int8_t* w, int B, int H, int W,
                        int C, int N, int kh, int kw, int stride, int pad,
                        int groups, int path, int mode, void* out,
                        const float* zp, const float* zp_map,
                        const float* scale, const float* bias,
                        const float* site_scale, int relu, int unsigned_site,
                        const int8_t* id_codes, const float* id_scale,
                        float id_zp, const float* id_float, float* feat,
                        void* stream) {
  ConvShape s;
  cudaError_t err = make_shape(B, H, W, C, N, kh, kw, stride, pad, groups, &s);
  if (err != cudaSuccess) return err;
  if (mode < kInt32 || mode > kResidual || out == nullptr ||
      (mode != kInt32 && (scale == nullptr || bias == nullptr)) ||
      ((mode == kSite || mode == kResidual) && site_scale == nullptr) ||
      (mode == kResidual && (id_codes == nullptr) == (id_float == nullptr)) ||
      (id_codes != nullptr && id_scale == nullptr))
    return cudaErrorInvalidValue;
  Epilogue e;
  e.mode = mode; e.out = out; e.zp = zp; e.zp_map = zp_map;
  e.scale = scale; e.bias = bias; e.site_scale = site_scale;
  e.relu = relu; e.unsigned_site = unsigned_site;
  e.id_codes = id_codes; e.id_scale = id_scale; e.id_zp = id_zp;
  e.id_float = id_float;
  e.feat = (mode == kSite || mode == kResidual) ? feat : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (!wgmma_takes(s, x, w)) return cudaErrorInvalidValue;
    if (s.C % 128 == 0) return launch_wgmma<128, 3>(x, w, s, e, st);
    return launch_wgmma<64, 4>(x, w, s, e, st);
  }
  if (path != 0) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((s.M + kBM - 1) / kBM),
            static_cast<unsigned>((s.Ng + kBN - 1) / kBN),
            static_cast<unsigned>(groups));
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  bool vec = s.Cg % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    int8_conv_mma_kernel<true><<<grid, kThreads, 0, st>>>(x, w, s, e);
  else
    int8_conv_mma_kernel<false><<<grid, kThreads, 0, st>>>(x, w, s, e);
  return cudaGetLastError();
}

}  // extern "C"
