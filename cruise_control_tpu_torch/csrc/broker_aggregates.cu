// K1 — per-broker aggregates of the replica axis, in one pass.
//
// Replaces cruise_control_tpu/ops/segment.py:22-42 (masked_segment_sum /
// masked_segment_count) as reached through analyzer/state.py:37
// BrokerArrays.from_model -> model/tensor_model.py:116-162 (broker_load,
// potential_leadership_load, broker_replica_counts, broker_leader_counts,
// broker_leader_bytes_in): five masked scatter-adds of replica rows into
// brokers, run at every optimizer step and every satisfied check.
//
// Bound on the card: bytes.  The function reads R * 38 bytes (broker id,
// two flags, two f32[4] load rows) and writes B * 32; at the mid rung that
// is ~0.4 MB, well under a microsecond at 3.35 TB/s, so a launch costs more
// than the work.
//
// Design: one block per broker.  The float sums must be the plain
// version's bits: its index_add_ on the CPU (and the JAX package's
// scatter-add) adds each broker's rows one after the other in increasing
// replica index, and a broker's band edge can fall between two roundings
// (the mid rung's default goal order parted the card from the CPU at
// CpuUsageDistributionGoal when K1 summed in its own order).  So the block
// walks the replica axis in passes of 1,024 rows; the threads holding a
// row of its broker stage the row's values in shared memory at the row's
// place in row order (warp ballots and an ordered prefix of their counts),
// and thread c adds column c of each staged row in turn: one chain of adds
// per column, in the CPU's order, reading only shared memory — no float
// atomics, so the result is also bit-identical run to run.  The block's body is
// k1::aggregate_block (broker_aggregates.cuh), which K10's blended
// aggregates (placement_score.cu) call with a batch axis.  Each block
// re-reads the 4-byte broker ids (B * R * 4 bytes: 2 MB at mid, 80 MB at
// the 200-broker rung), which stay in the 50 MB L2 because the id array
// itself is R * 4 bytes.  Counts are exact int32.
//
// cc_segment_sum is the same design for any masked f32[N, C] rows (C <= 16)
// into S segments: the per-broker round sums of the selection
// (cruise_control_tpu/analyzer/optimizer.py:663-668, a float scatter-add
// there, masked_segment_sum's index_add_ in the plain version).  Bound on
// the card: bytes (N * (4C + 5) read, S * 4C written; at the mid rung N =
// 32,768 lanes, C = 8: ~1.2 MB, a few tenths of a microsecond at 3.35
// TB/s).  One block per segment, its rows compacted in row order and each
// channel added by one thread in that order: the plain version's bits,
// and a CUDA graph replays it to the same bits every time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "broker_aggregates.cuh"

namespace {

constexpr int kThreads = k1::kThreads;

__global__ void broker_aggregates_kernel(
    const int32_t* __restrict__ replica_broker,
    const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ is_leader,
    const float* __restrict__ load_leader,    // [R, 4]
    const float* __restrict__ load_follower,  // [R, 4]
    int64_t num_replicas,
    float* __restrict__ load,                 // [B, 4]
    int32_t* __restrict__ replica_count,
    int32_t* __restrict__ leader_count,
    float* __restrict__ potential_nw_out,
    float* __restrict__ leader_bytes_in) {
  const int b = blockIdx.x;
  k1::aggregate_block(k1::Direct{replica_broker, is_leader}, k1::NoTopics{}, b, valid,
                      load_leader, load_follower, num_replicas, load + 4 * b,
                      replica_count + b, leader_count + b, potential_nw_out + b,
                      leader_bytes_in + b);
}

constexpr int kMaxChannels = 16;

// Rows a thread looks at in one pass of segment_sum's row-order walk: with
// 16 channels a pass's values fill 32 KB of shared memory.
constexpr int kSegChunks = 2;

__global__ void segment_sum_kernel(const float* __restrict__ values,  // [N, C]
                                   const int32_t* __restrict__ seg,
                                   const uint8_t* __restrict__ mask,
                                   int64_t n, int channels,
                                   float* __restrict__ out) {          // [S, C]
  __shared__ float s_val[kMaxChannels][kThreads * kSegChunks];
  __shared__ int32_t s_cnt[kSegChunks * k1::kWarps];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  float acc = 0.f;  // channel t (t < channels)
  for (int64_t base = 0; base < n; base += kThreads * kSegChunks) {
    bool flags[kSegChunks];
#pragma unroll
    for (int k = 0; k < kSegChunks; ++k) {
      const int64_t i = base + k * kThreads + t;
      flags[k] = i < n && mask[i] && seg[i] == s;
    }
    int pos[kSegChunks];
    const int total = k1::compact_pass<kSegChunks>(flags, pos, s_cnt);
#pragma unroll
    for (int k = 0; k < kSegChunks; ++k) {
      if (pos[k] < 0) continue;
      const float* row = values + (base + k * kThreads + t) * channels;
      for (int c = 0; c < channels; ++c) s_val[c][pos[k]] = row[c];
    }
    __syncthreads();
    if (t < channels)
      for (int j = 0; j < total; ++j) acc = __fadd_rn(acc, s_val[t][j]);
    __syncthreads();  // s_val and s_cnt are rewritten by the next pass
  }
  if (t < channels) out[static_cast<int64_t>(s) * channels + t] = acc;
}

}  // namespace

extern "C" int cc_segment_sum(const float* values, const int32_t* seg,
                              const uint8_t* mask, int64_t n, int64_t channels,
                              int64_t num_segments, float* out,
                              cudaStream_t stream) {
  if (num_segments <= 0) return 0;
  if (channels < 1 || channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<<<static_cast<unsigned>(num_segments), kThreads, 0, stream>>>(
      values, seg, mask, n, static_cast<int>(channels), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_broker_aggregates(
    const int32_t* replica_broker, const uint8_t* valid,
    const uint8_t* is_leader, const float* load_leader,
    const float* load_follower, int64_t num_replicas, float* load,
    int32_t* replica_count, int32_t* leader_count, float* potential_nw_out,
    float* leader_bytes_in, int64_t num_brokers, cudaStream_t stream) {
  if (num_brokers <= 0) return 0;
  broker_aggregates_kernel<<<static_cast<unsigned>(num_brokers), kThreads, 0,
                             stream>>>(
      replica_broker, valid, is_leader, load_leader, load_follower,
      num_replicas, load, replica_count, leader_count, potential_nw_out,
      leader_bytes_in);
  return static_cast<int>(cudaGetLastError());
}
