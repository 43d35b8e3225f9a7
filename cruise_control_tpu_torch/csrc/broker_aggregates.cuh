// K1's block body: one broker's aggregates of the replica axis, shared by
// K1 (broker_aggregates.cu, the model's own placement) and K10's blended
// aggregates (placement_score.cu, the placement of one execution
// checkpoint).  The order of the float adds is fixed — each thread's rows
// in replica order, then a fixed shared-memory tree — so both entries give
// the same bits for the same placement.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

constexpr int kThreads = 256;
constexpr int kFloats = 6;  // load[0..3], potential NW_OUT, leader NW_IN

// The model's own placement: replica r sits on replica_broker[r] and leads
// when is_leader[r].
struct Direct {
  const int32_t* replica_broker;
  const uint8_t* is_leader;
  __device__ __forceinline__ int32_t broker(int64_t r) const { return replica_broker[r]; }
  __device__ __forceinline__ bool leader(int64_t r) const { return is_leader[r] != 0; }
};

// No per-topic counts (K1).
struct NoTopics {
  __device__ __forceinline__ void add(int64_t) const {}
};

// The aggregates of broker ``b`` under placement ``pl``: sums of the valid
// replicas the placement puts on ``b``; ``topics.add(r)`` is called once
// for each of them.  Every thread of the block calls it; thread 0 writes
// load[0..3], replica_count[0], leader_count[0], potential_nw_out[0] and
// leader_bytes_in[0].
template <class Placement, class Topics>
__device__ void aggregate_block(const Placement& pl, const Topics& topics, int b,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ load_leader,
                                const float* __restrict__ load_follower,
                                int64_t num_replicas, float* load,
                                int32_t* replica_count, int32_t* leader_count,
                                float* potential_nw_out, float* leader_bytes_in) {
  __shared__ float s_f[kFloats][kThreads];
  __shared__ int32_t s_i[2][kThreads];
  const int t = threadIdx.x;
  float acc[kFloats] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int32_t cnt = 0, lcnt = 0;
  for (int64_t r = t; r < num_replicas; r += kThreads) {
    if (!valid[r] || pl.broker(r) != b) continue;
    const bool lead = pl.leader(r);
    const float* ll = load_leader + 4 * r;
    const float* row = lead ? ll : load_follower + 4 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += row[c];
    acc[4] += ll[2];                 // Resource.NW_OUT
    acc[5] += lead ? ll[1] : 0.f;    // Resource.NW_IN of leaders
    cnt += 1;
    lcnt += lead ? 1 : 0;
    topics.add(r);
  }
#pragma unroll
  for (int c = 0; c < kFloats; ++c) s_f[c][t] = acc[c];
  s_i[0][t] = cnt;
  s_i[1][t] = lcnt;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
#pragma unroll
      for (int c = 0; c < kFloats; ++c) s_f[c][t] += s_f[c][t + stride];
      s_i[0][t] += s_i[0][t + stride];
      s_i[1][t] += s_i[1][t + stride];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) load[c] = s_f[c][0];
    potential_nw_out[0] = s_f[4][0];
    leader_bytes_in[0] = s_f[5][0];
    replica_count[0] = s_i[0][0];
    leader_count[0] = s_i[1][0];
  }
}

}  // namespace k1
