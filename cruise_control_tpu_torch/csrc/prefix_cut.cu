// K3 — the bounded prefix-cut repair.
//
// Replaces cruise_control_tpu/analyzer/goals/kernels.py:997
// _sorted_prefix_tables + :1031 prefix_cut_admit (and, with the 2C split
// channels, :1062 prefix_admit_safe): per segment, keep the longest
// score-ranked prefix of kept lanes whose running channel totals stay
// inside [lo - eps, hi + eps] at EVERY position of the segment, with
// eps = 1e-6 * max(1, |finite hi|, |finite lo|) per channel.  The running
// total at sorted position p is cum_before of p's segment plus cs[p] minus
// cs at the position just before the segment's first, where cs is the
// global inclusive cumsum of the sorted kept deltas (an unkept position
// adds 0 but is tested).  The JAX function bisects over running
// bad-counts; the cut is the first out-of-band position, found here
// directly.
//
// The order is the JAX function's two stable argsorts (score descending,
// then segment).  The wrapper sorts once (cc_argsort of argsort.cu over the
// negated score) and groups the score-ordered rows by segment with the stable
// counting pass of broker_aggregates.cu (cc_segment_row_index over
// seg[by_score[i]], every row kept): it gives the segment offsets and, for
// sorted position p, the score position rows[p], that is row
// by_score[rows[p]].  Above 4,096 segments (every block of the counting
// pass scans all S counts: at 20,000 (topic, broker) keys one scatter
// took 0.38 ms on an H100) the wrapper regroups with a second cc_argsort,
// over the segment ids (S + 1 keys: two 8-bit passes at 20,000), and
// cc_sorted_offsets instead.
//
// cs must be the plain version's bits: ops/order.py ordered_cumsum, XLA's
// CPU scan — blocks of 16 positions each scanned in order, plus the scan
// of the block totals taken the same way, shifted by one block (the order
// of ordered.cuh).  So cs[p] is the in-order scan of p's block up to p,
// __fadd_rn the finished level-1 value of the block before.
//
// Bound on the card: bytes (K * (9 + 4C) read for the score, ids, flags
// and deltas, S * 12C for the bounds, K written); well under a
// microsecond at the main path's shapes, so launches and the latency of
// dependent loads are the cost.
//
// Design: four launches after the grouping, no host sync, scratch sized
// from (K, S, C) alone (K3 runs inside the captured step graphs):
//   (1) prefix_rows_kernel, a warp per 32 sorted positions: each lane
//       finds its row through the grouping, writes it and its segment id
//       in sorted order, loads its kept delta a channel at a time, and a
//       15-step shuffle scan gives the in-block scans of the warp's two
//       blocks of 16 (written out, f32[K, C]); the last lane of each block
//       writes the block's total.  The gathers are spread over positions,
//       so they run on every SM.
//   (2) prefix_scan_kernel, one block per channel: the block totals'
//       ordered cumsum in shared memory (K / 16 floats a channel), the
//       steps of ordered.cuh, written back in place as the finished
//       level-1 values; each segment's base (cs at the position before its
//       first) from its in-block scan and the level-1 value before it.
//       Block 0 resets the first-bad positions.
//   (3) prefix_flags_kernel, a thread per sorted position: cs = in-block
//       scan, __fadd_rn the level-1 value of the block before; the band
//       test per channel as the plain version takes it; the lowest
//       out-of-band lane of each segment in the warp (__match_any_sync,
//       __ballot_sync) takes an atomicMin on the segment's first bad
//       position.  One segment holding every row costs no more than many
//       short ones.
//   (4) prefix_admit_kernel, a thread per sorted position: out[row] = kept
//       and the position lies before its segment's first bad one; a row
//       whose id lies outside [0, S) is admitted nowhere.
// Every value is the plain version's arithmetic in its order, so the card
// and the plain version agree exactly.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxChannels = 16;
constexpr int64_t kBlock = ordered::kBlock;
constexpr int64_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in
constexpr int64_t kMaxSmem = 232448;         // shared memory a block can use

__global__ void prefix_rows_kernel(const int64_t* __restrict__ by_score,
                                   const int32_t* __restrict__ rows,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ seg,
                                   const float* __restrict__ deltas,
                                   const uint8_t* __restrict__ kept, int64_t k,
                                   int num_segments, int channels,
                                   int32_t* __restrict__ order,       // [K]
                                   int32_t* __restrict__ sorted_seg,  // [K]
                                   float* __restrict__ inblock,       // [K, C]
                                   float* __restrict__ level1) {      // [C, nb]
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nb = (k + kBlock - 1) / kBlock;
  // Past the grouped rows (ids outside [0, S)) and past K: no row, delta 0
  // (the plain version's zero padding).
  const int32_t r = p < offsets[num_segments] ? static_cast<int32_t>(by_score[rows[p]]) : -1;
  const bool kp = r >= 0 && kept[r];
  if (p < k) {
    order[p] = r;
    sorted_seg[p] = r >= 0 ? seg[r] : -1;
  }
  for (int c = 0; c < channels; ++c) {  // every lane runs every step: the shuffles
    const float x = kp ? deltas[static_cast<int64_t>(r) * channels + c] : 0.f;
    float acc = x;
#pragma unroll
    for (int j = 1; j < kBlock; ++j) {  // lane j of a block adds lane j - 1's finished scan
      const float prev = __shfl_up_sync(kFull, acc, 1);
      if ((lane & (kBlock - 1)) == j) acc = __fadd_rn(x, prev);
    }
    if (p < k) inblock[p * channels + c] = acc;
    if ((lane & (kBlock - 1)) == kBlock - 1 && p / kBlock < nb)
      level1[c * nb + p / kBlock] = acc;
  }
}

__global__ void prefix_scan_kernel(const int32_t* __restrict__ offsets,
                                   const float* __restrict__ inblock, int64_t k,
                                   int num_segments, int channels,
                                   float* __restrict__ level1,  // [C, nb], in place
                                   float* __restrict__ base,    // [S, C]
                                   int32_t* __restrict__ first_bad) {
  extern __shared__ float lv[];  // the levels: nb, ceil(nb / 16), ... floats
  const int c = blockIdx.x, t = threadIdx.x, S = num_segments;
  const int64_t nb = (k + kBlock - 1) / kBlock;
  if (c == 0)
    for (int s = t; s < S; s += blockDim.x) first_bad[s] = INT_MAX;
  for (int64_t b = t; b < nb; b += blockDim.x) lv[b] = level1[c * nb + b];
  // The ordered cumsum of the totals, in place, level by level (the steps
  // of ordered.cuh, a block of 16 per thread).
  float* level[ordered::kMaxLevels];
  int64_t size[ordered::kMaxLevels];
  int depth = 0;
  level[0] = lv;
  size[0] = nb;
  float* next = lv + nb;
  while (true) {
    __syncthreads();
    const int64_t m = size[depth], blocks = (m + kBlock - 1) / kBlock;
    for (int64_t b = t; b < blocks; b += blockDim.x) ordered::scan_block(level[depth], m, 1, b, 0);
    if (m <= kBlock || depth == ordered::kMaxLevels - 1) break;
    __syncthreads();
    for (int64_t b = t; b < blocks; b += blockDim.x)
      next[b] = ordered::block_total(level[depth], m, 1, b, 0);
    level[depth + 1] = next;
    size[depth + 1] = blocks;
    next += blocks;
    ++depth;
  }
  for (int d = depth - 1; d >= 0; --d) {
    __syncthreads();
    for (int64_t i = kBlock + t; i < size[d]; i += blockDim.x)
      ordered::add_back(level[d], i, 1, 0, level[d + 1]);
  }
  __syncthreads();
  for (int64_t b = t; b < nb; b += blockDim.x) level1[c * nb + b] = lv[b];
  // Segment s's base: cs at the position before its first (0 at position
  // 0; an empty segment's is never read).
  for (int s = t; s < S; s += blockDim.x) {
    const int64_t start = offsets[s];
    float cs = 0.f;
    if (start > 0 && start < offsets[s + 1]) {
      const int64_t q = start - 1;
      cs = inblock[q * channels + c];
      if (q >= kBlock) cs = __fadd_rn(cs, lv[q / kBlock - 1]);
    }
    base[static_cast<int64_t>(s) * channels + c] = cs;
  }
}

__global__ void prefix_flags_kernel(const int32_t* __restrict__ sorted_seg,
                                    const float* __restrict__ cum_before,  // [S, C]
                                    const float* __restrict__ lo,          // [S, C]
                                    const float* __restrict__ hi,          // [S, C]
                                    const int32_t* __restrict__ offsets,
                                    const float* __restrict__ inblock,
                                    const float* __restrict__ level1,
                                    const float* __restrict__ base, int64_t k,
                                    int num_segments, int channels,
                                    int32_t* __restrict__ first_bad) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nb = (k + kBlock - 1) / kBlock;
  const bool in = p < offsets[num_segments];
  const int s = in ? sorted_seg[p] : -1;
  bool ok = true;
  for (int c = 0; in && c < channels; ++c) {
    float cs = inblock[p * channels + c];
    if (p >= kBlock) cs = __fadd_rn(cs, level1[c * nb + p / kBlock - 1]);
    const int64_t sc = static_cast<int64_t>(s) * channels + c;
    const float h = hi[sc], l = lo[sc];
    const float scale = fmaxf(fmaxf(isfinite(h) ? fabsf(h) : 0.f,
                                    isfinite(l) ? fabsf(l) : 0.f), 1.f);
    const float eps = __fmul_rn(1e-6f, scale);
    const float prefix = __fsub_rn(__fadd_rn(cum_before[sc], cs), base[sc]);
    ok = ok && prefix <= __fadd_rn(h, eps) && prefix >= __fsub_rn(l, eps);
  }
  const bool bad = in && !ok;
  const unsigned bads = __ballot_sync(kFull, bad) & __match_any_sync(kFull, s);
  if (bad && lane == __ffs(bads) - 1) atomicMin(first_bad + s, static_cast<int>(p));
}

__global__ void prefix_admit_kernel(const int32_t* __restrict__ order,
                                    const int32_t* __restrict__ sorted_seg,
                                    const int32_t* __restrict__ seg,
                                    const uint8_t* __restrict__ kept,
                                    const int32_t* __restrict__ offsets,
                                    const int32_t* __restrict__ first_bad, int64_t k,
                                    int num_segments, uint8_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= k) return;
  if (p < offsets[num_segments]) {
    const int32_t r = order[p];
    out[r] = kept[r] && p < first_bad[sorted_seg[p]] ? 1 : 0;
  }
  const int32_t id = seg[p];  // row p itself
  if (id < 0 || id >= num_segments) out[p] = 0;
}

// offsets[s] = the first position whose key is s or more, over keys sorted
// ascending in [0, S] (S: outside every segment).
__global__ void sorted_offsets_kernel(const int32_t* __restrict__ keys, int64_t k,
                                      int num_segments, int32_t* __restrict__ offsets) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p > k) return;
  const int prev = p > 0 ? keys[p - 1] : -1;
  const int cur = p < k ? keys[p] : num_segments;
  for (int s = prev + 1; s <= cur && s <= num_segments; ++s)
    offsets[s] = static_cast<int32_t>(p);
}

unsigned grid_of(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// K3 after the grouping: by_score (i64[K], score order), rows and offsets
// (the grouping: i32[K], i32[S + 1]), the inputs, scratch order and
// sorted_seg (i32[K]), inblock (f32[K * C]), level1 (f32[C * ceil(K / 16)]),
// base (f32[S * C]) and first_bad (i32[S]), and out (bool[K]).
extern "C" int cc_prefix_cut(const int64_t* by_score, const int32_t* rows,
                             const int32_t* offsets, const int32_t* seg, const float* deltas,
                             const uint8_t* kept, const float* cum_before, const float* lo,
                             const float* hi, int32_t* order, int32_t* sorted_seg,
                             float* inblock, float* level1, float* base, int32_t* first_bad,
                             uint8_t* out, int64_t k, int64_t num_segments, int64_t channels,
                             cudaStream_t stream) {
  if (k <= 0 || num_segments <= 0) return 0;
  if (channels < 1 || channels > kMaxChannels || k >= INT_MAX || num_segments >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>(num_segments), C = static_cast<int>(channels);
  const int64_t smem = ordered::level_floats((k + kBlock - 1) / kBlock) *
                       static_cast<int64_t>(sizeof(float));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {  // past ~180,000 positions
    const cudaError_t rc = cudaFuncSetAttribute(
        prefix_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // Whole warps over the positions: the shuffle scans need every lane.
  const unsigned grid = grid_of(k);
  prefix_rows_kernel<<<grid, kThreads, 0, stream>>>(by_score, rows, offsets, seg, deltas,
                                                    kept, k, S, C, order, sorted_seg,
                                                    inblock, level1);
  prefix_scan_kernel<<<C, kScanThreads, static_cast<size_t>(smem), stream>>>(
      offsets, inblock, k, S, C, level1, base, first_bad);
  prefix_flags_kernel<<<grid, kThreads, 0, stream>>>(sorted_seg, cum_before, lo, hi, offsets,
                                                     inblock, level1, base, k, S, C,
                                                     first_bad);
  prefix_admit_kernel<<<grid, kThreads, 0, stream>>>(order, sorted_seg, seg, kept, offsets,
                                                     first_bad, k, S, out);
  return static_cast<int>(cudaGetLastError());
}

// The offsets of keys (i32[K], sorted ascending, each in [0, S]).
extern "C" int cc_sorted_offsets(const int32_t* keys, int32_t* offsets, int64_t k,
                                 int64_t num_segments, cudaStream_t stream) {
  if (num_segments <= 0) return 0;
  if (k < 0 || k >= INT_MAX || num_segments >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  sorted_offsets_kernel<<<grid_of(k + 1), kThreads, 0, stream>>>(
      keys, k, static_cast<int>(num_segments), offsets);
  return static_cast<int>(cudaGetLastError());
}
