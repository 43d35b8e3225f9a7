// K1's block body: one broker's aggregates of the replica axis, shared by
// K1 (broker_aggregates.cu, the model's own placement) and K10's blended
// aggregates (placement_score.cu, the placement of one execution
// checkpoint).  The float adds run in the plain version's row order, so
// both entries give the CPU's bits for the same placement.

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
  __device__ __forceinline__ void add(int64_t, bool) const {}
};

constexpr int kWarps = kThreads / 32;
// Rows one pass of the row-order walk looks at: kChunks rows a thread.
constexpr int kChunks = 4;
constexpr int kRows = kThreads * kChunks;

// One pass of the row-order walk over rows base + k * kThreads +
// threadIdx.x (k < Chunks): ``flags[k]`` is whether that row is wanted.
// Sets ``pos[k]`` to the row's place among the pass's wanted rows in
// increasing row order (-1 when it is not wanted) and returns their count,
// the same in every thread.  ``s_cnt`` holds Chunks * kWarps ints.  Every
// thread of the block calls it; it synchronises the block once, and the
// caller must synchronise before the next call.
template <int Chunks>
__device__ inline int compact_pass(const bool (&flags)[Chunks], int (&pos)[Chunks],
                                   int32_t* s_cnt) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  unsigned ballots[Chunks];
#pragma unroll
  for (int k = 0; k < Chunks; ++k) {
    ballots[k] = __ballot_sync(0xffffffffu, flags[k]);
    if (lane == 0) s_cnt[k * kWarps + w] = __popc(ballots[k]);
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int k = 0; k < Chunks; ++k) {
    for (int q = 0; q < kWarps; ++q) {
      if (q == w)
        pos[k] = flags[k] ? total + __popc(ballots[k] & ((1u << lane) - 1u)) : -1;
      total += s_cnt[k * kWarps + q];
    }
  }
  return total;
}

// The aggregates of broker ``b`` under placement ``pl``: sums of the valid
// replicas the placement puts on ``b``; ``topics.add(r, lead)`` is called
// once for each of them.  Every thread of the block calls it; thread 0
// writes replica_count[0] and leader_count[0], threads 0-5 the six float
// sums: load[0..3], potential_nw_out[0] and leader_bytes_in[0].
//
// The float sums are taken in the order of the plain version's index_add_
// on the CPU: each broker's rows one after the other in increasing replica
// index, from 0.  The block walks the replica axis in passes of kRows rows;
// the threads that hold a row of ``b`` write its six values to shared
// memory at the row's place in row order (compact_pass), and thread c then
// adds column c of the pass's rows in turn, so the card and the CPU hold
// the same bits.
template <class Placement, class Topics>
__device__ void aggregate_block(const Placement& pl, const Topics& topics, int b,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ load_leader,
                                const float* __restrict__ load_follower,
                                int64_t num_replicas, float* load,
                                int32_t* replica_count, int32_t* leader_count,
                                float* potential_nw_out, float* leader_bytes_in) {
  __shared__ float s_val[kFloats][kRows];
  __shared__ int32_t s_cnt[kChunks * kWarps];
  __shared__ int32_t s_i[2][kThreads];
  const int t = threadIdx.x;
  float acc = 0.f;  // column t of the sums (t < kFloats)
  int32_t cnt = 0, lcnt = 0;
  for (int64_t base = 0; base < num_replicas; base += kRows) {
    bool flags[kChunks], lead[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int64_t r = base + k * kThreads + t;
      flags[k] = r < num_replicas && valid[r] && pl.broker(r) == b;
      lead[k] = flags[k] && pl.leader(r);
      if (flags[k]) {
        cnt += 1;
        lcnt += lead[k] ? 1 : 0;
        topics.add(r, lead[k]);
      }
    }
    int pos[kChunks];
    const int total = compact_pass<kChunks>(flags, pos, s_cnt);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (pos[k] < 0) continue;
      const int64_t r = base + k * kThreads + t;
      const float* ll = load_leader + 4 * r;
      const float* row = lead[k] ? ll : load_follower + 4 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) s_val[c][pos[k]] = row[c];
      s_val[4][pos[k]] = ll[2];                   // Resource.NW_OUT
      s_val[5][pos[k]] = lead[k] ? ll[1] : 0.f;  // Resource.NW_IN of leaders
    }
    __syncthreads();
    if (t < kFloats)
      for (int j = 0; j < total; ++j) acc = __fadd_rn(acc, s_val[t][j]);
    __syncthreads();  // s_val and s_cnt are rewritten by the next pass
  }
  s_i[0][t] = cnt;
  s_i[1][t] = lcnt;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      s_i[0][t] += s_i[0][t + stride];
      s_i[1][t] += s_i[1][t + stride];
    }
    __syncthreads();
  }
  if (t < 4) load[t] = acc;
  if (t == 4) potential_nw_out[0] = acc;
  if (t == 5) leader_bytes_in[0] = acc;
  if (t == 0) {
    replica_count[0] = s_i[0][0];
    leader_count[0] = s_i[1][0];
  }
}

}  // namespace k1
