// Exact non-maximum suppression on the card for sm_90a: the keep mask of
// B independent problems of N boxes, with no host round trip.
//
// Replaces the JAX package's NMS fixpoint (hnd_ghnd_tpu/ops/nms.py:33
// nms_keep_mask and :94 batched_nms_mask: a lax.while_loop of masked matrix
// products, XLA ops and not a Pallas kernel), whose eager port
// (ops/nms.py:fixpoint) waits on the host once per iteration.  Box j is
// suppressed iff a kept box i "ranked above" j (a higher score, or an equal
// score and a lower index) of the same category, both valid, overlaps it
// by an IoU above the threshold.  That relation is a DAG, and its fixpoint
// is unique; greedy NMS over ANY order that puts every i before the j it is
// ranked above reaches the same set.  So:
//   1. nms_mask_kernel: thread (b, i) against 64 boxes j of one word writes
//      the 64-bit word of i's row: bit j iff i suppresses j if kept.  The
//      predicate is the plain version's (ops/nms.py:_suppression), IoU
//      (ops/boxes.py:pairwise_iou) included, one IEEE step per torch op in
//      the same order: __f*_rn intrinsics (nvcc would contract a * b + c
//      into an FMA), maxima and minima that propagate NaN as torch.maximum
//      does (fmaxf drops it), clamp(min=0) that keeps NaN, the union > 0
//      guard; bfloat16 boxes round every step to bfloat16 as torch's
//      bfloat16 ops do.  The same thread counts the boxes of its word that
//      come before i in a total order: NaN scores last, then descending
//      score, then ascending index (on non-NaN scores exactly "ranked
//      above"; a NaN score is ranked against nothing, so its place does not
//      matter), and adds the count to i's rank with one integer atomic:
//      exact in any order, and the ranks are a permutation.
//   2. nms_scan_kernel: one warp per problem puts the boxes in rank order
//      in shared memory and walks it: a valid box not yet removed is kept
//      and its row is OR-ed into the removed bitset, which the warp holds
//      in registers (lane l owns words l, l + 32, ...).  The walk is
//      sequential, so it is bound by latency: the rows of the next 32 /
//      WPL boxes are loaded together before they are decided, and a box's
//      removed bit reaches the warp with one shuffle.
// Bound on the H100: neither bytes nor operations.  The box head's problem
// is [8, 4096]: 8 x 4096^2 pairs of ~13 float operations (6.5 us at the
// 67 TFLOP/s float32 peak; a pair of boxes that are not both valid costs
// nothing in the plain version's semantics, so PERF.md counts valid
// pairs), 16 MB of mask; the scan is 4096 dependent steps per problem.
//
// The entry point launches both kernels and a memset of the ranks on the
// caller's stream and does not synchronise.  N <= kMaxBoxes (ops/nms.py
// MAX_BOXES).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 64;
constexpr int kMaskThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxWordsPerLane = 8;
constexpr int kMaxBoxes = kWarp * kMaxWordsPerLane * kWordBits;  // 16384

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}

// one rounding per torch op: none for float32 boxes, to bfloat16 for
// bfloat16 ones (torch computes a bfloat16 op in float32 and rounds it)
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return static_cast<float>(*p);
}
template <>
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x1, y1, x2, y2 and the area of a box, in the boxes' arithmetic
template <bool BF16>
struct Box {
  float x1, y1, x2, y2, area;
};

template <bool BF16, typename T>
__device__ __forceinline__ Box<BF16> load_box(const T* boxes, int64_t k) {
  Box<BF16> b;
  b.x1 = load_f(boxes + 4 * k + 0);
  b.y1 = load_f(boxes + 4 * k + 1);
  b.x2 = load_f(boxes + 4 * k + 2);
  b.y2 = load_f(boxes + 4 * k + 3);
  // area = (x2 - x1) * (y2 - y1)
  b.area = rnd<BF16>(__fmul_rn(rnd<BF16>(__fsub_rn(b.x2, b.x1)),
                               rnd<BF16>(__fsub_rn(b.y2, b.y1))));
  return b;
}

// pairwise_iou(boxes1 = i, boxes2 = j)[i, j] > threshold
template <bool BF16>
__device__ __forceinline__ bool iou_above(const Box<BF16>& a,
                                          const Box<BF16>& b, float thr) {
  float w = rnd<BF16>(__fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1)));
  float h = rnd<BF16>(__fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1)));
  w = w < 0.0f ? 0.0f : w;  // clamp(min=0) keeps NaN
  h = h < 0.0f ? 0.0f : h;
  float inter = rnd<BF16>(__fmul_rn(w, h));
  float uni = rnd<BF16>(__fsub_rn(rnd<BF16>(__fadd_rn(a.area, b.area)),
                                  inter));
  float iou = uni > 0.0f ? rnd<BF16>(__fdiv_rn(inter, uni)) : 0.0f;
  return iou > thr;
}

// "ranked above": s_i > s_j, or s_i == s_j and i < j (false for NaN)
__device__ __forceinline__ bool ranked_above(float si, int i, float sj,
                                             int j) {
  return si > sj || (si == sj && i < j);
}

// the total order of the scan: j comes before i
__device__ __forceinline__ bool comes_before(float sj, int j, float si,
                                             int i) {
  bool nj = sj != sj, ni = si != si;
  if (nj || ni) return (!nj && ni) || (nj && ni && j < i);
  return ranked_above(sj, j, si, i);
}

// grid (words, ceil(N / kMaskThreads), B); block kMaskThreads
template <bool BF16, typename T>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const T* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid,
                const int64_t* __restrict__ categories, int N, int words,
                float thr, unsigned long long* __restrict__ mask,
                int* __restrict__ rank) {
  __shared__ Box<BF16> cb[kWordBits];
  __shared__ float cs[kWordBits];
  __shared__ uint8_t cv[kWordBits];
  __shared__ int64_t cc[kWordBits];
  const int b = blockIdx.z;
  const int w = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * N;
  for (int t = threadIdx.x; t < kWordBits; t += blockDim.x) {
    int j = w * kWordBits + t;
    if (j < N) {
      cb[t] = load_box<BF16>(boxes, base + j);
      cs[t] = scores[base + j];
      cv[t] = valid[base + j];
      cc[t] = categories ? categories[base + j] : 0;
    }
  }
  __syncthreads();
  const int i = blockIdx.y * kMaskThreads + threadIdx.x;
  if (i >= N) return;
  const Box<BF16> bi = load_box<BF16>(boxes, base + i);
  const float si = scores[base + i];
  const bool vi = valid[base + i] != 0;
  const int64_t ci = categories ? categories[base + i] : 0;
  const int n = min(kWordBits, N - w * kWordBits);
  unsigned long long bits = 0ull;
  int before = 0;
  for (int t = 0; t < n; ++t) {
    const int j = w * kWordBits + t;
    before += comes_before(cs[t], j, si, i);
    if (vi && cv[t] && cc[t] == ci && ranked_above(si, i, cs[t], j) &&
        iou_above<BF16>(bi, cb[t], thr))
      bits |= 1ull << t;
  }
  mask[(base + i) * words + w] = bits;
  if (before) atomicAdd(rank + base + i, before);
}

// one warp per problem; dynamic shared memory: N ints (the order) and N
// bytes (validity)
template <int WPL>
__global__ void __launch_bounds__(kWarp)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const int* __restrict__ rank,
                const uint8_t* __restrict__ valid, int N, int words,
                uint8_t* __restrict__ keep) {
  constexpr int kAhead = kWarp / WPL;  // rows in flight
  extern __shared__ int smem[];
  int* order = smem;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + N);
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * N;
  for (int i = lane; i < N; i += kWarp) {
    order[rank[base + i]] = i;
    sv[i] = valid[base + i];
  }
  __syncwarp();
  unsigned long long removed[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) removed[k] = 0ull;
  for (int p0 = 0; p0 < N; p0 += kAhead) {
    int idx[kAhead];
    unsigned long long row[kAhead][WPL];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int p = p0 + c;
      idx[c] = p < N ? order[p] : -1;
      const bool load = idx[c] >= 0 && sv[idx[c]];
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const int w = lane + k * kWarp;
        row[c][k] = (load && w < words)
                        ? mask[(base + idx[c]) * words + w] : 0ull;
      }
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int i = idx[c];
      if (i < 0) break;  // uniform across the warp
      const int wi = i / kWordBits;
      unsigned long long word = 0ull;
#pragma unroll
      for (int k = 0; k < WPL; ++k)
        if (k == wi / kWarp) word = removed[k];
      const int gone = __shfl_sync(0xffffffffu,
                                   (int)((word >> (i % kWordBits)) & 1ull),
                                   wi % kWarp);
      const bool kept = sv[i] && !gone;
      if (kept) {
#pragma unroll
        for (int k = 0; k < WPL; ++k) removed[k] |= row[c][k];
      }
      if (lane == 0) keep[base + i] = kept;
    }
  }
}

template <int WPL>
cudaError_t launch_scan(const unsigned long long* mask, const int* rank,
                        const uint8_t* valid, int B, int N, int words,
                        uint8_t* keep, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(N) * (sizeof(int) + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<WPL><<<B, kWarp, smem, st>>>(mask, rank, valid, N, words,
                                                keep);
  return cudaGetLastError();
}

template <bool BF16, typename T>
cudaError_t launch_mask(const void* boxes, const float* scores,
                        const uint8_t* valid, const int64_t* categories,
                        int B, int N, int words, float thr,
                        unsigned long long* mask, int* rank,
                        cudaStream_t st) {
  dim3 grid(words, (N + kMaskThreads - 1) / kMaskThreads, B);
  nms_mask_kernel<BF16, T><<<grid, kMaskThreads, 0, st>>>(
      static_cast<const T*>(boxes), scores, valid, categories, N, words, thr,
      mask, rank);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The keep mask [B, N] (bytes 0/1) of B problems of N boxes.
// boxes: [B, N, 4] contiguous, float32 (boxes_bf16 = 0) or bfloat16 (1);
// scores: [B, N] float32 (a bfloat16 score converts exactly); valid: [B, N]
// bytes; categories: [B, N] int64 or null (no categories); iou_threshold:
// the float32 threshold; mask: B * N * ceil(N / 64) words of workspace;
// rank: B * N ints of workspace.  Returns a cudaError_t.
int hnd_nms_keep(const void* boxes, int boxes_bf16, const float* scores,
                 const uint8_t* valid, const int64_t* categories, int B,
                 int N, float iou_threshold, unsigned long long* mask,
                 int* rank, uint8_t* keep, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxBoxes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (N + kWordBits - 1) / kWordBits;
  cudaError_t err = cudaMemsetAsync(
      rank, 0, static_cast<size_t>(B) * N * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = boxes_bf16
            ? launch_mask<true, __nv_bfloat16>(boxes, scores, valid,
                                               categories, B, N, words,
                                               iou_threshold, mask, rank, st)
            : launch_mask<false, float>(boxes, scores, valid, categories, B,
                                        N, words, iou_threshold, mask, rank,
                                        st);
  if (err != cudaSuccess) return (int)err;
  const int wpl = (words + kWarp - 1) / kWarp;
  if (wpl <= 1) return (int)launch_scan<1>(mask, rank, valid, B, N, words, keep, st);
  if (wpl <= 2) return (int)launch_scan<2>(mask, rank, valid, B, N, words, keep, st);
  if (wpl <= 4) return (int)launch_scan<4>(mask, rank, valid, B, N, words, keep, st);
  return (int)launch_scan<8>(mask, rank, valid, B, N, words, keep, st);
}

}  // extern "C"
