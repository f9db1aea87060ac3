// Exact non-maximum suppression on the card for sm_90a: the keep mask of
// B independent problems, each cut into chunks whose boxes never suppress
// each other (one chunk for a plain problem, the RPN's five levels as
// five), with no host round trip.
//
// Replaces the JAX package's NMS fixpoint (hnd_ghnd_tpu/ops/nms.py:33
// nms_keep_mask and :94 batched_nms_mask: a lax.while_loop of masked matrix
// products, XLA ops and not a Pallas kernel; the RPN runs the first on each
// level, hnd_ghnd_tpu/models/rpn.py:143).  Box j is suppressed iff a kept
// box i "ranked above" j (a higher score, or an equal score and a lower
// index) of the same category (and chunk), both valid, overlaps it by an
// IoU above the threshold.  That relation is a DAG, and its fixpoint is
// unique; greedy NMS over ANY order that puts every i before the j it is
// ranked above reaches the same set, and boxes that cannot suppress each
// other need not share an order at all.  So:
//   1. nms_order_kernel, a block per (problem, chunk): the chunk's valid
//      boxes get 64-bit keys [segment | NaN score | descending score |
//      index] (the segment a 17-bit hash of the category, 0 without;
//      -0.0 as 0.0, so equal scores fall back on the index as "ranked
//      above" does; NaN scores last: they are ranked against nothing) and
//      are sorted by a bitonic sort in shared memory.  Invalid boxes drop
//      out.  A segment is a run of equal hashes: boxes of one category
//      always share one, and two categories that share a hash are told
//      apart by the mask's category test.  The block writes the sorted
//      boxes, scores, indices and categories, the segment table, and the
//      list of the mask's tiles: for a segment of t tiles of 64 rank
//      positions, the t(t+1)/2 pairs (row tile, column tile) on or above
//      the diagonal.
//   2. nms_mask_kernel: a group of 64 threads per tile pair writes the 64
//      words (one a row) of one column tile: bit t of row r iff r
//      suppresses column box t if r is kept.  Only same-segment pairs of
//      valid boxes, ranked one way, are computed: in the order a later
//      position is ranked below an earlier one unless its score is NaN.
//      The predicate is the plain version's (ops/nms.py:_suppression), IoU
//      (ops/boxes.py:pairwise_iou) included, one IEEE step per torch op in
//      the same order: __f*_rn intrinsics (nvcc would contract a * b + c
//      into an FMA), maxima and minima that propagate NaN as torch.maximum
//      does (fmaxf drops it), clamp(min=0) that keeps NaN, the union > 0
//      guard; bfloat16 boxes round every step to bfloat16 as torch's
//      bfloat16 ops do.  A pair with a zero intersection has an IoU of 0
//      and skips the rest.  The mask is stored column tile by column tile,
//      so a tile's 64 rows are 512 contiguous bytes.
//   3. nms_scan_kernel, a warp per segment, segments in parallel across
//      the SMs: the segment is walked in tiles of 64 rank positions.  A
//      tile's removed word comes from the kept rows of earlier tiles; its
//      64 boxes are resolved against the diagonal words (two a lane) by a
//      Jacobi iteration of "kept = live & ~(OR of the kept rows' words)",
//      one OR-reduction of the warp a step, which reaches the unique
//      fixpoint in at most 65 steps (in as many as the tile's longest
//      suppression chain, in practice); the tile's kept rows are then
//      OR-ed, column by column, into the removed words of the later tiles.
//      The dependent chain is ~V/64 tiles of register work for a segment of
//      V valid boxes, not N steps through global memory.
// Bound on the H100: neither bytes nor operations (PERF.md counts the IoU
// of each valid same-category pair).  What no design removes is the scan's
// chain: the longest segment's tiles, each a few reductions and one read
// of L2-resident mask words, behind three dependent launches.
//
// The entry point launches the three kernels on the caller's stream (no
// memset: the order pass zeroes the keep mask) and does not synchronise.
// A chunk holds at most kMaxBoxes boxes (ops/nms.py MAX_BOXES).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 64;
constexpr int kMaxBoxes = 16384;           // 14 index bits of the key
constexpr int kIdxBits = 14;
constexpr int kSegBits = 17;
constexpr int kMaxTiles = kMaxBoxes / kWordBits;  // 256
constexpr int kMaxChunks = 8;
constexpr int kOrderThreads = 1024;
constexpr int kMaskGroups = 4;             // tile pairs in flight a block
constexpr int kMaskThreads = kMaskGroups * kWordBits;
constexpr int kScanWarps = 4;
constexpr int kAhead = 16;                 // column tiles the scan prefetches
constexpr int kWarp = 32;
static_assert(kIdxBits + 32 + 1 + kSegBits == 64, "the key's fields");
static_assert((1 << kIdxBits) == kMaxBoxes, "an index per box of a chunk");

typedef unsigned long long u64;

// Where each chunk's data lives.  Per problem b, the boxes of chunk c are
// [off[c], off[c] + n[c]) of a row of M; the sorted arrays use the same
// positions; the tile list and the mask have a region per problem.
struct Layout {
  int L, M;
  int off[kMaxChunks];
  int n[kMaxChunks];
  long long items_off[kMaxChunks];  // in items, within a problem's region
  long long items_per_problem;
  long long mask_off[kMaxChunks];   // in words, within a problem's region
  long long mask_per_problem;
};

// The workspace's arrays.
struct Work {
  int* order;         // [B * M] the box (index in its chunk) at a position
  float4* sbox;       // [B * M] its coordinates
  float* sscore;      // [B * M] its score
  long long* scat;    // [B * M] its category
  int2* seg;          // [B * M] per chunk, segment k: (first position, len)
  int4* head;         // [B * L] (valid boxes, segments, tile pairs, 0)
  u64* items;         // the tile pairs (ops/nms.py: their bound)
  u64* mask;          // per chunk: [column tile][position] words
};

// torch.maximum / torch.minimum: NaN if either operand is NaN (they may
// differ from torch's in the sign of a zero result, which changes no
// IoU's comparison: a zero width or height gives a zero or NaN
// intersection either way)
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// one rounding per torch op: none for float32 boxes, to bfloat16 for
// bfloat16 ones (torch computes a bfloat16 op in float32 and rounds it)
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float load_f(const void* p, int64_t k, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[k])
              : static_cast<const float*>(p)[k];
}

// area = (x2 - x1) * (y2 - y1) of a box (x1, y1, x2, y2)
template <bool BF16>
__device__ __forceinline__ float box_area(float4 b) {
  return rnd<BF16>(__fmul_rn(rnd<BF16>(__fsub_rn(b.z, b.x)),
                             rnd<BF16>(__fsub_rn(b.w, b.y))));
}

// pairwise_iou(boxes1 = a, boxes2 = b)[a, b] > threshold, given the two
// areas; zero_above: 0 > threshold
template <bool BF16>
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float area_b, float thr,
                                          bool zero_above) {
  float w = rnd<BF16>(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)));
  float h = rnd<BF16>(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)));
  w = nan_max(w, 0.0f);  // clamp(min=0) keeps NaN
  h = nan_max(h, 0.0f);
  float inter = rnd<BF16>(__fmul_rn(w, h));
  // +-0 / union and the guard's 0 are both an IoU of +-0: most pairs do
  // not overlap, and skip the union and the division
  if (inter == 0.0f) return zero_above;
  float uni = rnd<BF16>(__fsub_rn(rnd<BF16>(__fadd_rn(area_a, area_b)),
                                  inter));
  float iou = uni > 0.0f ? rnd<BF16>(__fdiv_rn(inter, uni)) : 0.0f;
  return iou > thr;
}

// The category's segment: any fixed map to kSegBits bits would do (boxes
// of one category must share a segment; sharing one costs only time).
__device__ __forceinline__ unsigned seg_hash(long long c) {
  const unsigned long long u = static_cast<unsigned long long>(c);
  return static_cast<unsigned>(u ^ (u >> 17) ^ (u >> 34) ^ (u >> 51)) &
         ((1u << kSegBits) - 1);
}

// The scan's order as one integer: segment, then non-NaN scores by
// descending value (-0.0 as 0.0: the two are equal scores), then NaN
// scores, then the index.
__device__ __forceinline__ u64 make_key(unsigned seg, float s, int idx) {
  u64 key = static_cast<u64>(seg) << (64 - kSegBits);
  if (s != s) {
    key |= 1ull << (kIdxBits + 32);
  } else {
    unsigned bits = __float_as_uint(s == 0.0f ? 0.0f : s);
    const unsigned up = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    key |= static_cast<u64>(~up) << kIdxBits;
  }
  return key | static_cast<u64>(idx);
}

__device__ __forceinline__ unsigned key_seg(u64 key) {
  return static_cast<unsigned>(key >> (64 - kSegBits));
}

// Exclusive prefix sum of v over the block's threads; the total in *total.
// s_warp: 32 ints of shared memory.
__device__ int block_scan(int v, int* total, int* s_warp) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nw) s_warp[lane] = y;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? s_warp[w - 1] : 0);
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp may be reused
  return excl;
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_sort(u64* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // bit j of i is clear
        const u64 a = keys[i];
        const u64 c = keys[i + j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// tile pair -> 64 bits: first position of its segment in the chunk, the
// segment's length, row tile, column tile
__device__ __forceinline__ u64 pack_item(int start, int len, int ti, int tj) {
  return static_cast<u64>(start) | static_cast<u64>(len) << 16 |
         static_cast<u64>(ti) << 32 | static_cast<u64>(tj) << 40;
}

// grid B * L (block b * L + c: chunk c of problem b); block kOrderThreads;
// dynamic shared memory: the keys, a power of two >= the largest chunk
__global__ void __launch_bounds__(kOrderThreads)
nms_order_kernel(const void* __restrict__ boxes, int boxes_bf16,
                 const void* __restrict__ scores, int scores_bf16,
                 const uint8_t* __restrict__ valid,
                 const int64_t* __restrict__ categories, Layout lay, Work wk,
                 uint8_t* __restrict__ keep) {
  extern __shared__ u64 keys[];
  __shared__ int s_count;
  __shared__ int s_warp[kWarp];
  const int b = blockIdx.x / lay.L;
  const int c = blockIdx.x % lay.L;
  const int n = lay.n[c];
  const int64_t row = static_cast<int64_t>(b) * lay.M + lay.off[c];
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  // the valid boxes' keys, in any order (the sort orders them): one shared
  // atomic a warp
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool v = i < n && valid[row + i];
    if (i < n) keep[row + i] = 0;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_count, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (v) {
      const unsigned h = categories ? seg_hash(categories[row + i]) : 0u;
      keys[at] = make_key(h, load_f(scores, row + i, scores_bf16), i);
    }
  }
  __syncthreads();
  const int V = s_count;
  int pow2 = 1;
  while (pow2 < V) pow2 <<= 1;
  for (int i = V + threadIdx.x; i < pow2; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, pow2);

  // the sorted boxes; each thread a run of positions, for the scans below
  const int per = (V + blockDim.x - 1) / blockDim.x;
  const int lo = min(V, static_cast<int>(threadIdx.x) * per);
  const int hi = min(V, lo + per);
  int starts = 0;
  for (int p = lo; p < hi; ++p) {
    const u64 key = keys[p];
    const int i = static_cast<int>(key & ((1u << kIdxBits) - 1));
    const int64_t k = row + i;
    wk.order[row + p] = i;
    wk.sbox[row + p] = make_float4(
        load_f(boxes, 4 * k + 0, boxes_bf16), load_f(boxes, 4 * k + 1,
                                                     boxes_bf16),
        load_f(boxes, 4 * k + 2, boxes_bf16), load_f(boxes, 4 * k + 3,
                                                     boxes_bf16));
    wk.sscore[row + p] = load_f(scores, k, scores_bf16);
    wk.scat[row + p] = categories ? categories[k] : 0;
    starts += p == 0 || key_seg(key) != key_seg(keys[p - 1]);
  }
  // the segments' first positions, in order
  int S = 0;
  int k = block_scan(starts, &S, s_warp);
  for (int p = lo; p < hi; ++p)
    if (p == 0 || key_seg(keys[p]) != key_seg(keys[p - 1]))
      wk.seg[row + k++].x = p;
  __syncthreads();
  // their lengths and tile pairs
  const int sper = (S + blockDim.x - 1) / blockDim.x;
  const int slo = min(S, static_cast<int>(threadIdx.x) * sper);
  const int shi = min(S, slo + sper);
  int pairs = 0;
  for (int s = slo; s < shi; ++s) {
    const int end = s + 1 < S ? wk.seg[row + s + 1].x : V;
    const int len = end - wk.seg[row + s].x;
    wk.seg[row + s].y = len;
    const int t = (len + kWordBits - 1) / kWordBits;
    pairs += t * (t + 1) / 2;
  }
  int P = 0;
  int first = block_scan(pairs, &P, s_warp);  // also orders the writes above
  int* prefix = reinterpret_cast<int*>(keys);  // the keys are done with
  for (int s = slo; s < shi; ++s) {
    prefix[s] = first;
    const int t = (wk.seg[row + s].y + kWordBits - 1) / kWordBits;
    first += t * (t + 1) / 2;
  }
  __syncthreads();
  u64* items = wk.items + b * lay.items_per_problem + lay.items_off[c];
  for (int u = threadIdx.x; u < P; u += blockDim.x) {
    int a = 0, z = S - 1;  // the last segment whose first pair is <= u
    while (a < z) {
      const int m = (a + z + 1) / 2;
      if (prefix[m] <= u) a = m; else z = m - 1;
    }
    const int v = u - prefix[a];  // -> column tile tj, row tile ti <= tj
    int tj = static_cast<int>((sqrtf(8.0f * v + 1.0f) - 1.0f) * 0.5f);
    while ((tj + 1) * (tj + 2) / 2 <= v) ++tj;
    while (tj * (tj + 1) / 2 > v) --tj;
    const int2 sg = wk.seg[row + a];
    items[u] = pack_item(sg.x, sg.y, v - tj * (tj + 1) / 2, tj);
  }
  if (threadIdx.x == 0) wk.head[blockIdx.x] = make_int4(V, S, P, 0);
}

// grid (gx, B * L); block kMaskThreads: group g of 64 threads takes tile
// pairs g, g + 4, ... of the block's share, thread r a row of the pair.
// "Ranked above" needs no test: in a segment every position after a row's
// is ranked below it unless its score is NaN (the order puts equal scores
// by index and NaN scores last), so a column is a candidate iff its score
// is not NaN.
template <bool BF16, bool kCats>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(Layout lay, Work wk, float thr) {
  __shared__ float4 cb[kMaskGroups][kWordBits];
  __shared__ float ca[kMaskGroups][kWordBits];
  __shared__ long long cc[kMaskGroups][kWordBits];
  __shared__ unsigned cand[kMaskGroups][2];  // candidate columns, by warp
  const int b = blockIdx.y / lay.L;
  const int c = blockIdx.y % lay.L;
  const int P = wk.head[blockIdx.y].z;
  const int g = threadIdx.x / kWordBits;
  const int r = threadIdx.x % kWordBits;
  const int n = lay.n[c];
  const int64_t row = static_cast<int64_t>(b) * lay.M + lay.off[c];
  const u64* items = wk.items + b * lay.items_per_problem + lay.items_off[c];
  u64* mask = wk.mask + b * lay.mask_per_problem + lay.mask_off[c];
  const bool zero_above = 0.0f > thr;
  for (int base = blockIdx.x * kMaskGroups; base < P;
       base += gridDim.x * kMaskGroups) {
    const int u = base + g;
    int start = 0, len = 0, ti = 0, tj = 0;
    if (u < P) {
      const u64 it = items[u];
      start = static_cast<int>(it & 0xffff);
      len = static_cast<int>((it >> 16) & 0xffff);
      ti = static_cast<int>((it >> 32) & 0xff);
      tj = static_cast<int>((it >> 40) & 0xff);
    }
    const int col = kWordBits * tj + r;
    bool ok = false;
    if (col < len) {
      const int64_t p = row + start + col;
      cb[g][r] = wk.sbox[p];
      ca[g][r] = box_area<BF16>(wk.sbox[p]);
      if (kCats) cc[g][r] = wk.scat[p];
      ok = wk.sscore[p] == wk.sscore[p];
    }
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (r % kWarp == 0) cand[g][r / kWarp] = m;
    __syncthreads();
    const int rl = kWordBits * ti + r;
    if (rl < len) {
      const int64_t p = row + start + rl;
      const float4 bi = wk.sbox[p];
      const float ai = box_area<BF16>(bi);
      const long long ki = kCats ? wk.scat[p] : 0;
      // candidate columns, after the row's own position
      u64 live = cand[g][0] | static_cast<u64>(cand[g][1]) << 32;
      if (ti == tj) live &= r + 1 < kWordBits ? ~0ull << (r + 1) : 0ull;
      u64 bits = 0ull;
#pragma unroll 4
      for (int t = 0; t < kWordBits; ++t) {
        if (((live >> t) & 1ull) && (!kCats || cc[g][t] == ki) &&
            iou_above<BF16>(bi, ai, cb[g][t], ca[g][t], thr, zero_above))
          bits |= 1ull << t;
      }
      mask[static_cast<int64_t>(tj) * n + start + rl] = bits;
    }
    __syncthreads();
  }
}

// OR of a 64-bit word over the warp
__device__ __forceinline__ u64 warp_or(u64 w) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(w));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(w >> 32));
  return static_cast<u64>(hi) << 32 | lo;
}

// The boxes kept in a tile: the fixpoint of kept = live & ~(OR of the
// diagonal words of the kept rows), lane l holding rows l and l + 32.  The
// words have bits after their own row only, so position p is final one
// step after every position before it: at most 65 steps.
__device__ __forceinline__ u64 resolve_tile(u64 live, u64 d0, u64 d1,
                                            int lane) {
  u64 kept = live;
  for (int step = 0; step <= kWordBits; ++step) {
    const u64 w = (((kept >> lane) & 1ull) ? d0 : 0ull) |
                  (((kept >> (lane + kWarp)) & 1ull) ? d1 : 0ull);
    const u64 next = live & ~warp_or(w);
    if (next == kept) break;  // uniform across the warp
    kept = next;
  }
  return kept;
}

// grid (gy, B * L); block kScanWarps warps: warp w takes segments
// blockIdx.x * kScanWarps + w, then every gy * kScanWarps-th
__global__ void __launch_bounds__(kScanWarps * kWarp)
nms_scan_kernel(Layout lay, Work wk, uint8_t* __restrict__ keep) {
  __shared__ u64 removed[kScanWarps][kMaxTiles];
  const int b = blockIdx.y / lay.L;
  const int c = blockIdx.y % lay.L;
  const int S = wk.head[blockIdx.y].y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n = lay.n[c];
  const int64_t row = static_cast<int64_t>(b) * lay.M + lay.off[c];
  const u64* mask = wk.mask + b * lay.mask_per_problem + lay.mask_off[c];
  u64* rm = removed[warp];
  for (int s = blockIdx.x * kScanWarps + warp; s < S;
       s += gridDim.x * kScanWarps) {
    const int2 sg = wk.seg[row + s];
    const int T = (sg.y + kWordBits - 1) / kWordBits;
    for (int t = lane; t < T; t += kWarp) rm[t] = 0ull;
    // rows of tile ti, column tile tj: mask[tj * n + start + 64 ti + r]
    const u64* col = mask + sg.x;
    int nrow = min(kWordBits, sg.y);
    u64 d0 = lane < nrow ? col[lane] : 0ull;
    u64 d1 = lane + kWarp < nrow ? col[lane + kWarp] : 0ull;
    __syncwarp();
    for (int ti = 0; ti < T; ++ti) {
      const int r0 = kWordBits * ti;
      const u64 rows = nrow == kWordBits ? ~0ull : (1ull << nrow) - 1ull;
      // this tile's rows of the next kAhead column tiles, and its boxes,
      // in flight while the tile is resolved
      u64 w0[kAhead], w1[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const u64* w = col + static_cast<int64_t>(ti + 1 + k) * n + r0;
        const bool more = ti + 1 + k < T;
        w0[k] = more && lane < nrow ? w[lane] : 0ull;
        w1[k] = more && lane + kWarp < nrow ? w[lane + kWarp] : 0ull;
      }
      const int* ord = wk.order + row + sg.x + r0;
      const int i0 = lane < nrow ? ord[lane] : 0;
      const int i1 = lane + kWarp < nrow ? ord[lane + kWarp] : 0;
      const u64 kept = resolve_tile(rows & ~rm[ti], d0, d1, lane);
      // the next diagonal, in flight while this tile's rows are OR-ed
      const int next_rows = min(kWordBits, sg.y - r0 - kWordBits);
      u64 n0 = 0ull, n1 = 0ull;
      if (ti + 1 < T) {
        const u64* dn = col + static_cast<int64_t>(ti + 1) * n + r0 +
                        kWordBits;
        if (lane < next_rows) n0 = dn[lane];
        if (lane + kWarp < next_rows) n1 = dn[lane + kWarp];
      }
      const bool k0 = (kept >> lane) & 1ull;
      const bool k1 = (kept >> (lane + kWarp)) & 1ull;
      if (k0) keep[row + i0] = 1;
      if (k1) keep[row + i1] = 1;
      if (kept) {
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          if (ti + 1 + k < T) {  // uniform across the warp
            const u64 o = warp_or((k0 ? w0[k] : 0ull) | (k1 ? w1[k] : 0ull));
            if (lane == 0) rm[ti + 1 + k] |= o;
          }
        }
        const u64* rw = col + r0;
#pragma unroll 4
        for (int tj = ti + 1 + kAhead; tj < T; ++tj) {
          const u64* w = rw + static_cast<int64_t>(tj) * n;
          const u64 v = (k0 ? w[lane] : 0ull) | (k1 ? w[lane + kWarp] : 0ull);
          const u64 o = warp_or(v);
          if (lane == 0) rm[tj] |= o;
        }
      }
      __syncwarp();
      d0 = n0;
      d1 = n1;
      nrow = next_rows;
    }
    __syncwarp();
  }
}

// The workspace of B problems cut into chunks of sizes[0..L): its layout
// and its bytes.
bool make_layout(int B, int L, const int* sizes, Layout* lay, Work* wk,
                 char* base, long long* bytes) {
  if (B <= 0 || L <= 0 || L > kMaxChunks) return false;
  lay->L = L;
  long long m = 0, items = 0, words = 0;
  for (int c = 0; c < L; ++c) {
    const int n = sizes[c];
    if (n < 0 || n > kMaxBoxes) return false;
    const long long t = (n + kWordBits - 1) / kWordBits;
    // the tile pairs of any split of n boxes into segments: at most
    // n * max(1, (t + 1) / 64) (a segment of m boxes and s tiles has
    // s(s+1)/2 pairs: one for m <= 64, else fewer than m(s+1)/64)
    const long long per = (t + 1 + kWordBits - 1) / kWordBits;
    lay->off[c] = static_cast<int>(m);
    lay->n[c] = n;
    lay->items_off[c] = items;
    lay->mask_off[c] = words;
    m += n;
    items += n * (per > 1 ? per : 1);
    words += t * n;
  }
  if (m > (1ll << 30)) return false;
  for (int c = L; c < kMaxChunks; ++c) {
    lay->off[c] = lay->n[c] = 0;
    lay->items_off[c] = lay->mask_off[c] = 0;
  }
  lay->M = static_cast<int>(m);
  lay->items_per_problem = items;
  lay->mask_per_problem = words;
  const long long bm = B * m;
  long long at = 0;
  auto take = [&](long long n) {
    const long long here = at;
    at += (n + 15) & ~15ll;
    return reinterpret_cast<char*>(reinterpret_cast<uintptr_t>(base) + here);
  };
  wk->sbox = reinterpret_cast<float4*>(take(16 * bm));
  wk->seg = reinterpret_cast<int2*>(take(8 * bm));
  wk->scat = reinterpret_cast<long long*>(take(8 * bm));
  wk->items = reinterpret_cast<u64*>(take(8 * B * items));
  wk->mask = reinterpret_cast<u64*>(take(8 * B * words));
  wk->head = reinterpret_cast<int4*>(take(16ll * B * L));
  wk->order = reinterpret_cast<int*>(take(4 * bm));
  wk->sscore = reinterpret_cast<float*>(take(4 * bm));
  *bytes = at;
  return true;
}

}  // namespace

extern "C" {

// Bytes of workspace hnd_nms_keep needs for B problems cut into L chunks
// of sizes[0..L) boxes; written to *bytes.  Returns a cudaError_t.
int hnd_nms_work_bytes(int B, int L, const int* sizes, long long* bytes) {
  Layout lay;
  Work wk;
  return make_layout(B, L, sizes, &lay, &wk, nullptr, bytes)
             ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// The keep mask [B, M] (bytes 0/1) of B problems of M boxes, each cut into
// L chunks of sizes[0..L) consecutive boxes that never suppress each
// other.  boxes: [B, M, 4] contiguous, float32 (boxes_bf16 = 0) or
// bfloat16 (1); scores: [B, M], float32 or bfloat16 (scores_bf16); valid:
// [B, M] bytes; categories: [B, M] int64 or null (no categories);
// iou_threshold: the threshold in the boxes' dtype, as a float; work:
// hnd_nms_work_bytes bytes, 16-byte aligned.  Returns a cudaError_t.
int hnd_nms_keep(const void* boxes, int boxes_bf16, const void* scores,
                 int scores_bf16, const uint8_t* valid,
                 const int64_t* categories, int B, int L, const int* sizes,
                 float iou_threshold, void* work, uint8_t* keep,
                 void* stream) {
  Layout lay;
  Work wk;
  long long bytes = 0;
  if (!make_layout(B, L, sizes, &lay, &wk, static_cast<char*>(work),
                   &bytes) ||
      (reinterpret_cast<uintptr_t>(work) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int most = 1;
  for (int c = 0; c < L; ++c) most = sizes[c] > most ? sizes[c] : most;
  int pow2 = 1;
  while (pow2 < most) pow2 <<= 1;
  const int tiles = (most + kWordBits - 1) / kWordBits;
  const size_t smem = static_cast<size_t>(pow2) * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  nms_order_kernel<<<B * L, kOrderThreads, smem, st>>>(
      boxes, boxes_bf16, scores, scores_bf16, valid, categories, lay, wk,
      keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // enough groups for one segment's pairs, two each
  int gx = (tiles * (tiles + 1) / 2 + 2 * kMaskGroups - 1) /
           (2 * kMaskGroups);
  gx = gx < 1 ? 1 : gx > 64 ? 64 : gx;
  const dim3 grid(gx, B * L);
  if (boxes_bf16 && categories)
    nms_mask_kernel<true, true><<<grid, kMaskThreads, 0, st>>>(
        lay, wk, iou_threshold);
  else if (boxes_bf16)
    nms_mask_kernel<true, false><<<grid, kMaskThreads, 0, st>>>(
        lay, wk, iou_threshold);
  else if (categories)
    nms_mask_kernel<false, true><<<grid, kMaskThreads, 0, st>>>(
        lay, wk, iou_threshold);
  else
    nms_mask_kernel<false, false><<<grid, kMaskThreads, 0, st>>>(
        lay, wk, iou_threshold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a segment a chunk without categories; with them, up to 64 at once
  const int gy = categories ? 16 : 1;
  nms_scan_kernel<<<dim3(gy, B * L), kScanWarps * kWarp, 0, st>>>(lay, wk,
                                                                   keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
