// K2 — per segment, keep the single highest-scored eligible lane.
//
// Replaces cruise_control_tpu/analyzer/optimizer.py:210 _best_per_segment:
// a scatter-max of the scores, then a scatter-min of the indices of the
// lanes that reached the max; ties go to the lowest index, and a segment
// whose best eligible score is +inf (or NaN) keeps no lane, because the
// JAX function requires isfinite of the winner.
//
// Bound on the card: bytes (K * 9 read, K written, plus an 8-byte key per
// segment); a few tens of KB per call on the main path, so every call is
// launch-bound.
//
// Design: two passes, exact and deterministic because max does not depend
// on order.
//   pass 1: each eligible lane does one 64-bit atomicMax on its segment's
//           key = order-preserving bits of the score << 32
//                 | (0xFFFFFFFF - lane index),
//           so the max key is the max score and, among equal scores, the
//           lowest index.  -0.0 is canonicalised to +0.0 first (the JAX
//           comparison treats them as equal), and +inf takes part.
//   pass 2: keep = eligible & isfinite(score) & key[seg] == own key.
// Key 0 marks an empty segment; no eligible lane can produce it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long lane_key(float s, int64_t i) {
  if (s == 0.0f) s = 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(s);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__global__ void segment_max_key(const float* __restrict__ score,
                                const int32_t* __restrict__ seg,
                                const uint8_t* __restrict__ eligible,
                                int64_t k, int64_t num_segments,
                                unsigned long long* __restrict__ keys) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k || !eligible[i]) return;
  const int32_t s = seg[i];
  if (s < 0 || s >= num_segments) return;
  atomicMax(keys + s, lane_key(score[i], i));
}

__global__ void segment_winner(const float* __restrict__ score,
                               const int32_t* __restrict__ seg,
                               const uint8_t* __restrict__ eligible,
                               int64_t k, int64_t num_segments,
                               const unsigned long long* __restrict__ keys,
                               uint8_t* __restrict__ keep) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k) return;
  uint8_t out = 0;
  if (eligible[i]) {
    const int32_t s = seg[i];
    const float v = score[i];
    if (s >= 0 && s < num_segments && isfinite(v))
      out = keys[s] == lane_key(v, i) ? 1 : 0;
  }
  keep[i] = out;
}

}  // namespace

extern "C" int cc_best_per_segment(const float* score, const int32_t* seg,
                                   const uint8_t* eligible, int64_t k,
                                   int64_t num_segments,
                                   unsigned long long* keys, uint8_t* keep,
                                   cudaStream_t stream) {
  if (k <= 0) return 0;
  if (k > 0xFFFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * num_segments, stream);
  const unsigned blocks = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  segment_max_key<<<blocks, kThreads, 0, stream>>>(score, seg, eligible, k,
                                                   num_segments, keys);
  segment_winner<<<blocks, kThreads, 0, stream>>>(score, seg, eligible, k,
                                                  num_segments, keys, keep);
  return static_cast<int>(cudaGetLastError());
}
