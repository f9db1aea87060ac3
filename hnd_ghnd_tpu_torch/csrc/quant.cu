// Affine 8-bit quantize / dequantize of the bottleneck tensor for sm_90a.
//
// Replaces hnd_ghnd_tpu/ops/pallas_quant.py: pallas_quantize (_quant_kernel,
// with its min/max as an XLA reduction outside the kernel) and
// pallas_dequantize (_dequant_kernel).
//
// Bound on the H100: bytes.  Quantize reads 4 B and writes 1 B per element,
// dequantize the reverse; the tensor is [B, 212, 340, 3] f32 (6.9 MB at
// B=8), 2.6 us at 3.35 TB/s, about one launch's latency.  So the design
// counts launches and trips to memory, not instructions.
//
// Quantize is one cooperative launch of a grid the device holds at once (its
// SM count x the blocks per SM the occupancy API gives for this kernel, read
// once per device):
//   1. every thread loads up to kSlots items (four float4, or eight floats
//      on the scalar path) into registers and takes their min and max; the
//      items beyond what the grid's registers hold are read in a grid-stride
//      loop and reduced the same way; warp shuffles and shared memory reduce
//      the block, and each block writes one (min, max) pair;
//   2. one grid-wide barrier (cooperative_groups grid sync; the launch
//      guarantees that every block is resident);
//   3. every block reduces all the pairs itself, in the same order, so
//      every block holds the same (min, max), and computes the scale and
//      zero point (block 0 also writes them to work[0, 1]);
//   4. the codes of the items in registers are written without a second
//      read; only the items beyond the registers are read again (from L2 at
//      these sizes: 27.7 MB at B=32 against a 50 MB L2).
// Blocks of 512 threads, at least two a SM (at most 64 registers a thread):
// on an H100 the grid's registers hold at least 2.16 M floats, the whole
// tensor at B=8.
// min/max is exact in any order, so the result does not depend on the grid.
// No float atomics.  16-byte loads where x is 16-byte aligned and n % 4 ==
// 0; else a scalar path, right for any storage offset and any n.  The codes
// of one float4 are one 4-byte store (a warp writes 128 contiguous bytes);
// a thread owning four consecutive float4 and storing their 16 codes at
// once measured no faster (its loads are 64 bytes apart).
// The design before this one (three launches: partial min/max, a one-block
// finalize, the codes) took 0.0135 ms of card time at B=8; this one takes
// 0.0106 ms, of which the cooperative launch with its barrier alone takes
// 0.0060 (chip_roi_ab.py in turns on an H100 80GB HBM3 at 700 W; PERF.md).
//
// Dequantize is one launch: each thread loads 16 codes (one 16-byte vector)
// and stores four float4, staged per warp through shared memory so that
// each store instruction writes 512 contiguous bytes; a scalar tail, and a
// scalar path for unaligned views.  Its 0.0073 ms at B=8 are an empty
// kernel's launch (0.0050) and 2.3 us of work.
//
// Bit-exactness with codec/quantizer.py:quantize_tensor (the CPU formula):
//   * divisions are IEEE round-to-nearest (__fdiv_rn), never a
//     reciprocal-multiply;
//   * additions and products go through __fadd_rn/__fmul_rn so nvcc cannot
//     contract them into an FMA the CPU formula does not have;
//   * a code is rounded half to even (like jnp.round / torch.round) by
//     adding 1.5 x 2^23 after the clamp, where the floats' spacing is 1, and
//     is the low byte of the sum's bits;
//   * the zero point truncates toward zero (int cast), as the reference's
//     int(...) does.
// Non-finite inputs follow the JAX package on the CPU (ROADMAP C12): min
// and max propagate NaN (min.NaN / max.NaN), so a NaN anywhere makes the
// scale 1; the clamps of the zero point and of each code then keep fmaxf's
// rule, which returns the other operand for NaN, so a NaN zero point or
// code becomes 0, as XLA's convert of NaN does.
// Build without --use_fast_math.

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // dequantize
constexpr int kQuantThreads = 512;
constexpr int kQuantBlocks = 2;        // per SM: at most 64 registers a thread
constexpr float kRound = 12582912.0f;  // 1.5 x 2^23
constexpr float kTwo23 = 8388608.0f;   // 2^23
constexpr int kMaxDevices = 64;

// min and max that return NaN if either operand is NaN, as jnp.min/max and
// torch.min/max do (fminf/fmaxf return the other operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void minmax(float& lo, float& hi, float v) {
  lo = min_nan(lo, v);
  hi = max_nan(hi, v);
}

__device__ __forceinline__ void minmax(float& lo, float& hi, float4 v) {
  lo = min_nan(min_nan(lo, v.x), min_nan(v.y, min_nan(v.z, v.w)));
  hi = max_nan(max_nan(hi, v.x), max_nan(v.y, max_nan(v.z, v.w)));
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Block-wide min/max of (lo, hi); the result is valid in thread 0.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[32];
  __shared__ float s_hi[32];
  warp_minmax(lo, hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's reads of s_lo / s_hi are done
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

// The bits of rint(clamp(zp + v / scale, 0, qmax)) + 1.5 x 2^23: the code is
// the low byte.  A NaN quotient clamps to 0.
__device__ __forceinline__ uint32_t code_bits(float v, float scale, float zp,
                                              float qmax) {
  const float q = fminf(fmaxf(__fadd_rn(zp, __fdiv_rn(v, scale)), 0.0f), qmax);
  return __float_as_uint(__fadd_rn(q, kRound));
}

// The codes of one item: a float's byte, a float4's four bytes in a word.
__device__ __forceinline__ uint8_t codes(float v, float scale, float zp,
                                         float qmax) {
  return (uint8_t)code_bits(v, scale, zp, qmax);
}

__device__ __forceinline__ uint32_t codes(float4 v, float scale, float zp,
                                          float qmax) {
  return __byte_perm(__byte_perm(code_bits(v.x, scale, zp, qmax),
                                 code_bits(v.y, scale, zp, qmax), 0x0040),
                     __byte_perm(code_bits(v.z, scale, zp, qmax),
                                 code_bits(v.w, scale, zp, qmax), 0x0040),
                     0x5410);
}

template <typename T>
struct CodesOf;
template <>
struct CodesOf<float> { using type = uint8_t; };
template <>
struct CodesOf<float4> { using type = uint32_t; };

// Quantize in one launch (see the top of the file).  T: float4 (x 16-byte
// aligned, n % 4 == 0) or float.  A round of the grid covers kSlots grid
// strides of items; a thread's item s of a round is one grid stride from
// its item s + 1.  work: [0, 1] the scale and zero point out, then one
// (min, max) pair per block.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads, kQuantBlocks)
quantize_kernel(const T* __restrict__ x, int64_t n_items, float qmax,
                typename CodesOf<T>::type* __restrict__ q,
                float* __restrict__ work) {
  constexpr int kSlots = sizeof(T) == 16 ? 4 : 8;
  const int64_t stride = (int64_t)gridDim.x * kQuantThreads;
  const int64_t tid = (int64_t)blockIdx.x * kQuantThreads + threadIdx.x;
  const int64_t per_round = stride * kSlots;
  const int64_t rounds = (n_items + per_round - 1) / per_round;
  auto item = [&](int64_t r, int s) -> int64_t {
    return (r * kSlots + s) * stride + tid;
  };

  // 1. min/max: round 0 stays in registers, later rounds are reduced
  T v[kSlots];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (item(0, s) < n_items) v[s] = x[item(0, s)];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (item(0, s) < n_items) minmax(lo, hi, v[s]);
  for (int64_t r = 1; r < rounds; ++r) {
    T w[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (item(r, s) < n_items) w[s] = x[item(r, s)];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (item(r, s) < n_items) minmax(lo, hi, w[s]);
  }
  block_minmax(lo, hi);
  float2* pairs = reinterpret_cast<float2*>(work + 2);
  if (threadIdx.x == 0) pairs[blockIdx.x] = make_float2(lo, hi);

  // 2. every block's pair is written
  cg::this_grid().sync();

  // 3. all the pairs, one load a thread while they are at most one a
  // thread, reduced in the same order in every block (through L2: the
  // other SMs wrote them), then quantize_tensor's scalar arithmetic in its
  // exact order
  lo = INFINITY;
  hi = -INFINITY;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kQuantThreads) {
    const float2 p = __ldcg(pairs + b);
    lo = min_nan(lo, p.x);
    hi = max_nan(hi, p.y);
  }
  block_minmax(lo, hi);
  __shared__ float s_meta[2];
  if (threadIdx.x == 0) {
    const float raw_scale = __fdiv_rn(__fsub_rn(hi, lo), qmax);
    const float scale = raw_scale > 0.0f ? raw_scale : 1.0f;
    const float initial_zp = __fsub_rn(0.0f, __fdiv_rn(lo, scale));
    // a NaN initial_zp (a NaN, or an infinite min) clamps to 0
    const float clipped = fminf(fmaxf(initial_zp, 0.0f), qmax);
    s_meta[0] = scale;
    s_meta[1] = (float)(int)clipped;  // truncation toward zero
    if (blockIdx.x == 0) {
      work[0] = s_meta[0];
      work[1] = s_meta[1];
    }
  }
  __syncthreads();
  const float scale = s_meta[0];
  const float zp = s_meta[1];

  // 4. the codes: round 0 from registers, later rounds read again
  auto store = [&](int64_t r, const T* u) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (item(r, s) < n_items) q[item(r, s)] = codes(u[s], scale, zp, qmax);
  };
  store(0, v);
  for (int64_t r = 1; r < rounds; ++r) {
    T w[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (item(r, s) < n_items) w[s] = x[item(r, s)];
    store(r, w);
  }
}

// The float of a code: byte k of w under the bits of 2^23, minus 2^23
// (exact, and no int-to-float conversion).
__device__ __forceinline__ float code_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k)),
                   kTwo23);
}

__device__ __forceinline__ float dequant_one(float v, float scale, float zp) {
  return __fmul_rn(scale, __fsub_rn(v, zp));
}

__device__ __forceinline__ float4 dequant_word(uint32_t w, float scale,
                                               float zp) {
  return make_float4(dequant_one(code_float(w, 0), scale, zp),
                     dequant_one(code_float(w, 1), scale, zp),
                     dequant_one(code_float(w, 2), scale, zp),
                     dequant_one(code_float(w, 3), scale, zp));
}

// One uint4 of codes a thread, staged per warp through shared memory so
// that the four float4 stores coalesce: the warp's 32 uint4 are 128 float4
// of out; lane l produces float4 4l..4l+3 and stores float4 l, 32 + l, 64 +
// l and 96 + l.  Float4 j of lane l sits at 4l + (j + l / 2) % 4, so that
// eight lanes' 16-byte writes (and reads) fall in eight distinct bank
// quads.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ q, int64_t n,
                  const float* __restrict__ scale_ptr,
                  const float* __restrict__ zp_ptr, float* __restrict__ out) {
  __shared__ float4 s_out[kThreads * 4];
  const float scale = *scale_ptr;
  const float zp = *zp_ptr;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int64_t n16 = n / 16;
    const uint4* q16 = reinterpret_cast<const uint4*>(q);
    float4* out4 = reinterpret_cast<float4*>(out);
    const int lane = threadIdx.x & 31;
    float4* tile = s_out + (threadIdx.x - lane) * 4;
    // a warp's 32 lanes walk together (stride is a multiple of 32)
    for (int64_t base = tid - lane; base < n16; base += stride) {
      if (base + lane < n16) {
        const uint4 v = q16[base + lane];
        const int rot = lane >> 1;
        tile[4 * lane + (rot & 3)] = dequant_word(v.x, scale, zp);
        tile[4 * lane + ((rot + 1) & 3)] = dequant_word(v.y, scale, zp);
        tile[4 * lane + ((rot + 2) & 3)] = dequant_word(v.z, scale, zp);
        tile[4 * lane + ((rot + 3) & 3)] = dequant_word(v.w, scale, zp);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = 32 * k + lane;  // float4 f of the warp's 128
        const int src = f >> 2;       // from lane src, its float4 f % 4
        if (base + src < n16)
          out4[4 * base + f] = tile[4 * src + (((f & 3) + (src >> 1)) & 3)];
      }
      __syncwarp();
    }
    done = n16 * 16;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = dequant_one((float)q[i], scale, zp);
}

// The launch floor: an empty kernel, and an empty cooperative kernel with
// one grid barrier.
__global__ void empty_kernel() {}

__global__ void barrier_kernel() { cg::this_grid().sync(); }

// ------------------------------------------------------------------ host

std::atomic<int> quantize_cap[kMaxDevices];    // blocks; -1: no coop launch
std::atomic<int> dequantize_cap[kMaxDevices];

// The blocks of `kernel` the current device holds at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int dev, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  *blocks = sms * per_sm;
  return err;
}

// The largest grid of the quantize kernels on the current device: the
// blocks that every one of them can keep resident at once (read once per
// device).  cudaErrorNotSupported without cooperative launch.
cudaError_t quantize_grid_cap(int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = dev < kMaxDevices ? quantize_cap[dev].load(std::memory_order_acquire)
                            : 0;
  if (c == 0) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    c = -1;
    if (coop) {
      int a = 0, b = 0;
      err = resident_blocks(quantize_kernel<float4>, kQuantThreads, dev, &a);
      if (err == cudaSuccess)
        err = resident_blocks(quantize_kernel<float>, kQuantThreads, dev, &b);
      if (err != cudaSuccess) return err;
      c = a < b ? a : b;
      if (c < 1) return cudaErrorCooperativeLaunchTooLarge;
    }
    if (dev < kMaxDevices)
      quantize_cap[dev].store(c, std::memory_order_release);
  }
  if (c < 0) return cudaErrorNotSupported;
  *cap = c;
  return cudaSuccess;
}

cudaError_t dequantize_grid_cap(int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = dev < kMaxDevices
              ? dequantize_cap[dev].load(std::memory_order_acquire)
              : 0;
  if (c == 0) {
    err = resident_blocks(dequantize_kernel, kThreads, dev, &c);
    if (err != cudaSuccess) return err;
    if (c < 1) c = 1;
    if (dev < kMaxDevices)
      dequantize_cap[dev].store(c, std::memory_order_release);
  }
  *cap = c;
  return cudaSuccess;
}

// Blocks of `threads` for `items` units of one thread's work, at least 1,
// at most `cap`.
int grid_for(int64_t items, int threads, int cap) {
  const int64_t blocks = (items + threads - 1) / threads;
  return (int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <typename T>
cudaError_t launch_quantize(const T* x, int64_t n_items, float qmax,
                            typename CodesOf<T>::type* q, float* work,
                            int cap, cudaStream_t s) {
  void* args[] = {&x, &n_items, &qmax, &q, &work};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quantize_kernel<T>),
      dim3(grid_for(n_items, kQuantThreads, cap)), dim3(kQuantThreads), args,
      0, s);
}

}  // namespace

extern "C" {

// Floats of the work buffer hnd_quantize_u8 takes on the current device:
// the scale and zero point, then a (min, max) pair per block of its largest
// grid.  A value <= 0 is a CUDA error, negated.
int hnd_quantize_work_floats() {
  int cap = 0;
  const cudaError_t err = quantize_grid_cap(&cap);
  return err != cudaSuccess ? -(int)err : 2 + 2 * cap;
}

// x: n float32 on the device; q: n uint8 codes out; work: the floats
// hnd_quantize_work_floats gives, [0] the scale and [1] the zero point out.
int hnd_quantize_u8(const float* x, uint8_t* q, float* work, int64_t n,
                    int num_bits, void* stream) {
  if (n <= 0 || num_bits < 1 || num_bits > 8)
    return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = quantize_grid_cap(&cap);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = (float)((1 << num_bits) - 1);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  if ((xa & 15) == 0 && (qa & 3) == 0 && n % 4 == 0)
    err = launch_quantize(reinterpret_cast<const float4*>(x), n / 4, qmax,
                          reinterpret_cast<uint32_t*>(q), work, cap, s);
  else
    err = launch_quantize(x, n, qmax, q, work, cap, s);
  return (int)err;
}

// scale and zero_point are device scalars (quantize writes them to work[0]
// and work[1]; the wire may deliver them elsewhere).
int hnd_dequantize_u8(const uint8_t* q, const float* scale,
                      const float* zero_point, float* out, int64_t n,
                      void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = dequantize_grid_cap(&cap);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for((n + 15) / 16, kThreads, cap);
  dequantize_kernel<<<blocks, kThreads, 0, s>>>(q, n, scale, zero_point, out);
  return (int)cudaGetLastError();
}

// The launch floor beside the pair on n elements: grid_barrier 0 launches
// an empty kernel on dequantize's grid, 1 an empty cooperative kernel with
// one grid barrier on quantize's (16-byte loads).
int hnd_launch_floor(int64_t n, int grid_barrier, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err =
      grid_barrier ? quantize_grid_cap(&cap) : dequantize_grid_cap(&cap);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_barrier)
    return (int)cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(barrier_kernel),
        dim3(grid_for((n + 3) / 4, kQuantThreads, cap)), dim3(kQuantThreads),
        nullptr, 0, s);
  const int blocks = grid_for((n + 15) / 16, kThreads, cap);
  empty_kernel<<<blocks, kThreads, 0, s>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
