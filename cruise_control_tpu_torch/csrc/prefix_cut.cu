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
// The caller supplies ``order``: the two stable sorts of the JAX function
// (score descending, then segment), done by torch.sort.  Everything after
// the sort happens here.
//
// Bound on the card: bytes (K * (9 + 4C) read, S * 12C read, K written);
// well under a microsecond at the main path's shapes, so launch-bound.
//
// Design: one block per segment.  The block finds its range of sorted
// positions by binary search over seg[order[.]], then walks it in chunks of
// 256 positions: each thread loads its position's C channel deltas (zero
// when not kept), a warp-shuffle scan plus a scan of the 8 warp totals gives
// the block-inclusive prefix per channel, the carry from earlier chunks is
// added, and every position (kept or not) is tested against the band.  The
// first bad position of the segment ends the walk.  The segmented sum rounds
// differently from the JAX function's global cumsum minus the segment base,
// so a position within ~2 eps of a bound can test differently.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 16;

__device__ __forceinline__ int32_t seg_at(const int32_t* order,
                                          const int32_t* seg, int64_t p) {
  return seg[order[p]];
}

__global__ void prefix_cut_kernel(const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ seg,
                                  const float* __restrict__ deltas,   // [K, C]
                                  const uint8_t* __restrict__ kept,
                                  const float* __restrict__ cum_before,  // [S, C]
                                  const float* __restrict__ lo,          // [S, C]
                                  const float* __restrict__ hi,          // [S, C]
                                  uint8_t* __restrict__ out,
                                  int64_t k, int channels) {
  __shared__ float s_warp[kMaxChannels][kWarps];
  __shared__ int s_first_bad;
  __shared__ int64_t s_range[2];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

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
  }
  __syncthreads();
  const int64_t start = s_range[0];
  const int64_t end = s_range[1];
  if (start >= end) return;

  float carry[kMaxChannels], hi_c[kMaxChannels], lo_c[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < channels) {
      carry[c] = cum_before[b * channels + c];
      const float h = hi[b * channels + c];
      const float l = lo[b * channels + c];
      const float scale = fmaxf(1.0f, fmaxf(isfinite(h) ? fabsf(h) : 0.0f,
                                            isfinite(l) ? fabsf(l) : 0.0f));
      const float eps = 1e-6f * scale;
      hi_c[c] = h + eps;
      lo_c[c] = l - eps;
    }
  }

  int64_t cut = end - start;
  for (int64_t base = start; base < end; base += kThreads) {
    const int64_t p = base + t;
    const bool in = p < end;
    const int32_t idx = in ? order[p] : 0;
    const bool use = in && kept[idx];
    float v[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < channels) {
        float x = use ? deltas[static_cast<int64_t>(idx) * channels + c] : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xFFFFFFFFu, x, off);
          if (lane >= off) x += y;
        }
        v[c] = x;
        if (lane == 31) s_warp[c][warp] = x;
      }
    }
    if (t == 0) s_first_bad = INT_MAX;
    __syncthreads();
    bool ok = true;
    float total[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < channels) {
        float before = 0.0f, sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) before += s_warp[c][w];
          sum += s_warp[c][w];
        }
        total[c] = sum;
        const float prefix = carry[c] + (before + v[c]);
        ok = ok && (prefix <= hi_c[c]) && (prefix >= lo_c[c]);
      }
    }
    if (in && !ok) atomicMin(&s_first_bad, static_cast<int>(p - start));
    __syncthreads();
    const int first_bad = s_first_bad;
    __syncthreads();  // s_warp / s_first_bad are rewritten next chunk
    if (first_bad != INT_MAX) {
      cut = first_bad;
      break;
    }
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < channels) carry[c] += total[c];
  }
  for (int64_t p = start + t; p < end; p += kThreads) {
    const int32_t idx = order[p];
    out[idx] = (kept[idx] && (p - start) < cut) ? 1 : 0;
  }
}

}  // namespace

extern "C" int cc_prefix_cut(const int32_t* order, const int32_t* seg,
                             const float* deltas, const uint8_t* kept,
                             const float* cum_before, const float* lo,
                             const float* hi, uint8_t* out, int64_t k,
                             int64_t num_segments, int64_t channels,
                             cudaStream_t stream) {
  if (k <= 0 || num_segments <= 0) return 0;
  if (channels < 1 || channels > kMaxChannels || k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  prefix_cut_kernel<<<static_cast<unsigned>(num_segments), kThreads, 0,
                      stream>>>(order, seg, deltas, kept, cum_before, lo, hi,
                                out, k, static_cast<int>(channels));
  return static_cast<int>(cudaGetLastError());
}
