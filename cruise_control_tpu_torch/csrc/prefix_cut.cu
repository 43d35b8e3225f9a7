// K3 — the bounded prefix-cut repair, after the sort.
//
// Replaces cruise_control_tpu/analyzer/goals/kernels.py:997
// _sorted_prefix_tables + :1031 prefix_cut_admit (and, with the 2C split
// channels, :1062 prefix_admit_safe): per segment, keep the longest
// score-ranked prefix of kept lanes whose running channel totals
// (cum_before of the segment plus the kept deltas so far) stay inside
// [lo - eps, hi + eps] at EVERY position of the segment, with
// eps = 1e-6 * max(1, |finite hi|, |finite lo|) per channel.  The JAX
// function finds the cut by a ceil(log2(K+1))-step bisection over running
// bad-counts; the cut is the number of positions before the first bad one,
// which is what this kernel computes directly.
//
// The caller supplies ``order``, the two stable sorts of the JAX function
// (score descending, then segment), done by torch.sort, and ``cs``, the
// running channel totals of the sorted kept deltas over the whole batch
// (f32[K, C]): the JAX function's cumsum with its rounding, taken by
// cc_ordered_cumsum (ordered.cu) in the order of ops/order.py
// ordered_cumsum, so the CPU and the card hold the same bits.  Everything
// after that happens in prefix_cut_kernel.
//
// Bound on the card: bytes (K * (9 + 4C) read, S * 12C read, K written);
// well under a microsecond at the main path's shapes, so launch-bound.
//
// Design: one block per segment.  The block finds its range of sorted
// positions by binary search over seg[order[.]]; every thread tests its
// positions: running total = cum_before + cs - the segment's base (cs at
// the position before the segment), in the JAX function's order, against
// [lo - eps, hi + eps] per channel; an atomicMin finds the first bad
// position, and every kept lane before it is admitted.  The same
// arithmetic as the plain version, so the two agree exactly.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

__device__ __forceinline__ int32_t seg_at(const int32_t* order,
                                          const int32_t* seg, int64_t p) {
  return seg[order[p]];
}

__global__ void prefix_cut_kernel(const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ seg,
                                  const float* __restrict__ cs,       // [K, C]
                                  const uint8_t* __restrict__ kept,
                                  const float* __restrict__ cum_before,  // [S, C]
                                  const float* __restrict__ lo,          // [S, C]
                                  const float* __restrict__ hi,          // [S, C]
                                  uint8_t* __restrict__ out,
                                  int64_t k, int channels) {
  __shared__ int s_first_bad;
  __shared__ int64_t s_range[2];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (t == 0) {
    // lower_bound(b) and lower_bound(b + 1) over the sorted segment ids.
    int64_t lo_i = 0, hi_i = k;
    while (lo_i < hi_i) {
      const int64_t mid = (lo_i + hi_i) >> 1;
      if (seg_at(order, seg, mid) < b) lo_i = mid + 1; else hi_i = mid;
    }
    int64_t lo_j = lo_i, hi_j = k;
    while (lo_j < hi_j) {
      const int64_t mid = (lo_j + hi_j) >> 1;
      if (seg_at(order, seg, mid) <= b) lo_j = mid + 1; else hi_j = mid;
    }
    s_range[0] = lo_i;
    s_range[1] = lo_j;
    s_first_bad = INT_MAX;
  }
  __syncthreads();
  const int64_t start = s_range[0];
  const int64_t end = s_range[1];
  if (start >= end) return;
  float before[kMaxChannels], base[kMaxChannels], hi_c[kMaxChannels], lo_c[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < channels) {
      before[c] = cum_before[b * channels + c];
      base[c] = start > 0 ? cs[(start - 1) * channels + c] : 0.0f;
      const float h = hi[b * channels + c];
      const float l = lo[b * channels + c];
      const float scale = fmaxf(fmaxf(isfinite(h) ? fabsf(h) : 0.0f,
                                      isfinite(l) ? fabsf(l) : 0.0f), 1.0f);
      const float eps = __fmul_rn(1e-6f, scale);
      hi_c[c] = __fadd_rn(h, eps);
      lo_c[c] = __fsub_rn(l, eps);
    }
  }
  for (int64_t p = start + t; p < end; p += kThreads) {
    bool ok = true;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < channels) {
        const float prefix = __fsub_rn(__fadd_rn(before[c], cs[p * channels + c]), base[c]);
        ok = ok && (prefix <= hi_c[c]) && (prefix >= lo_c[c]);
      }
    }
    if (!ok) atomicMin(&s_first_bad, static_cast<int>(p - start));
  }
  __syncthreads();
  const int64_t cut = s_first_bad == INT_MAX ? end - start : s_first_bad;
  for (int64_t p = start + t; p < end; p += kThreads) {
    const int32_t idx = order[p];
    out[idx] = (kept[idx] && (p - start) < cut) ? 1 : 0;
  }
}

}  // namespace

extern "C" int cc_prefix_cut(const int32_t* order, const int32_t* seg,
                             const float* cs, const uint8_t* kept,
                             const float* cum_before, const float* lo,
                             const float* hi, uint8_t* out, int64_t k,
                             int64_t num_segments, int64_t channels,
                             cudaStream_t stream) {
  if (k <= 0 || num_segments <= 0) return 0;
  if (channels < 1 || channels > kMaxChannels || k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  prefix_cut_kernel<<<static_cast<unsigned>(num_segments), kThreads, 0,
                      stream>>>(order, seg, cs, kept, cum_before, lo, hi,
                                out, k, static_cast<int>(channels));
  return static_cast<int>(cudaGetLastError());
}
