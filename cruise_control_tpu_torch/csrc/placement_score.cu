// K10 — the balancedness of execution checkpoints: every goal's satisfied
// flag for a batch of C blends of two placements, in two launches.
//
// Replaces cruise_control_tpu/analyzer/optimizer.py:2392
// _get_placement_score_fn (called by PlacementScorer.score, :2474): for each
// landed-partition mask m[c, P], the replicas of landed partitions take the
// after model's broker and leader flag and every other replica the before
// model's, then _stack_satisfied (:2331) runs on the blend —
// BrokerArrays.from_model and goal_satisfied for each of the G goals.  The
// result is bool[C, G]; the offline flag is dropped there, so it is not
// computed here.
//
// cc_blend_aggregates is K1 with a batch axis: grid (B, C), block (b, c)
// runs K1's block body (broker_aggregates.cuh) over the blend of checkpoint
// c, reading the blend through the mask — rmask = m[c, replica_partition[r]]
// picks after[r] or before[r] — so no copy of the model is ever built.  The
// float adds run in K1's fixed order, so an all-false mask gives K1's bits.
// With a topic goal in the stack it also counts replicas per (c, topic,
// broker) into i32[C, T, B], and with a min-topic-leaders goal leaders per
// (c, topic, broker) into another i32[C, T, B], with integer atomics
// (exact, in any order; the caller zeroes the buffers).
//
// cc_blend_disk_load adds the disk loads of each blend for the intra-broker
// disk goals: grid (B, C), block (b, c) walks the replica axis in K1's
// passes, keeps the valid replicas whose blended disk belongs to broker b
// (disk_broker), stages their DISK loads in row order in shared memory
// (k1::compact_pass) and lets thread j add those on the broker's j-th disk
// in turn: each disk's sum in the CPU index_add_'s row order, f32[C, D].
//
// cc_stack_sweep_batch is K9's sweep with a batch axis: grid (G, C), block
// (g, c) runs K9's per-goal body (stack_sweep.cuh) on checkpoint c's slice
// of the aggregates (the disk kinds checkpoint c's row of the disk loads);
// the rack kinds read the blended broker of each replica
// and of each sibling through the mask, the preferred-leader kind the
// blended leader flags and brokers and each preferred replica's blended
// offline flag (replica_offline_now of the blend: on a dead broker or a
// dead disk, or reported offline and still on its original broker).  Band
// averages use ordered.cuh's windowed sums, as K9 does, so the band edges
// are the bits of the plain version.
//
// A partition index is clamped into [0, P) before it indexes a mask row, as
// the JAX package's gather clamps (padded replicas hold partition 0 and are
// not valid, so they count nowhere).
//
// Bound on the card: bytes.  The function must read the C x P masks, the
// two placements (broker ids and leader flags), the replica partitions,
// valid flags, topics and load rows once, and write C x B x 32 bytes of
// aggregates, the C x T x B topic (and topic leader) counts and C x G
// flags: at the mid rung
// (C = 256, P ~ 3.4k, R ~ 10k, B = 50) ~1.7 MB, half a microsecond at
// 3.35 TB/s.  This simple design is far from it: every (b, c) block
// re-reads the replica axis (B x C x R x ~14 bytes, from L2), which is what
// a later, faster version has to remove.  With a disk goal in the stack the
// function also reads both placements' disks and the disk rows and writes
// C x D disk loads; cc_blend_disk_load re-reads the replica axis per (b, c)
// block in the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "broker_aggregates.cuh"
#include "stack_sweep.cuh"

namespace {

// The placement of checkpoint c: replica r takes the after placement when
// its partition landed.
struct Blend {
  const uint8_t* mask;  // m[c, :], P entries
  const int32_t* partition;
  int64_t p;
  const int32_t *before, *after;
  const uint8_t *before_lead, *after_lead;
  // The offline flags of the blend (the sweep's preferred-leader kind).
  const int32_t *before_disk, *after_disk;
  const float* disk_capacity;
  const uint8_t *reported_offline, *valid;
  const int32_t* original;
  const int8_t* state;
  __device__ __forceinline__ bool landed(int64_t r) const {
    int64_t q = partition[r];
    q = q < 0 ? 0 : (q >= p ? p - 1 : q);
    return mask[q] != 0;
  }
  __device__ __forceinline__ int32_t broker(int64_t r) const {
    return landed(r) ? after[r] : before[r];
  }
  __device__ __forceinline__ bool leader(int64_t r) const {
    return (landed(r) ? after_lead[r] : before_lead[r]) != 0;
  }
  // TensorClusterModel.replica_offline_now of the blend.
  __device__ __forceinline__ bool offline_now(int64_t r) const {
    if (!valid[r]) return false;
    const int32_t b = broker(r);
    const int32_t disk = landed(r) ? after_disk[r] : before_disk[r];
    const bool dead_disk = disk >= 0 && disk_capacity[disk] < 0.f;
    const bool sticky = reported_offline[r] && b == original[r];
    return state[b] == k9::kDead || dead_disk || sticky;
  }
};

// Replicas and leaders per (topic, broker) of one checkpoint (null: not
// wanted).
struct TopicCounts {
  const int32_t* topic;
  int32_t* counts;   // [T, B] of checkpoint c
  int32_t* leaders;  // [T, B] of checkpoint c
  int64_t b_total;
  int b;
  __device__ __forceinline__ void add(int64_t r, bool lead) const {
    if (counts != nullptr) atomicAdd(counts + topic[r] * b_total + b, 1);
    if (leaders != nullptr && lead) atomicAdd(leaders + topic[r] * b_total + b, 1);
  }
};

__global__ void blend_aggregates_kernel(
    const uint8_t* __restrict__ masks, const int32_t* __restrict__ partition,
    int64_t p, const int32_t* __restrict__ before_rb, const int32_t* __restrict__ after_rb,
    const uint8_t* __restrict__ before_lead, const uint8_t* __restrict__ after_lead,
    const uint8_t* __restrict__ valid, const float* __restrict__ load_leader,
    const float* __restrict__ load_follower, const int32_t* __restrict__ topic,
    int64_t num_replicas, int64_t num_brokers, int64_t num_topics, float* load,
    int32_t* replica_count, int32_t* leader_count, float* potential_nw_out,
    float* leader_bytes_in, int32_t* topic_counts, int32_t* topic_leaders) {
  const int b = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int64_t cb = c * num_brokers + b;
  Blend pl{};
  pl.mask = masks + c * p;
  pl.partition = partition;
  pl.p = p;
  pl.before = before_rb;
  pl.after = after_rb;
  pl.before_lead = before_lead;
  pl.after_lead = after_lead;
  const int64_t tb = c * num_topics * num_brokers;
  const TopicCounts topics{topic, topic_counts == nullptr ? nullptr : topic_counts + tb,
                           topic_leaders == nullptr ? nullptr : topic_leaders + tb,
                           num_brokers, b};
  k1::aggregate_block(pl, topics, b, valid, load_leader, load_follower, num_replicas,
                      load + 4 * cb, replica_count + cb, leader_count + cb,
                      potential_nw_out + cb, leader_bytes_in + cb);
}

__global__ void blend_disk_load_kernel(
    const uint8_t* __restrict__ masks, const int32_t* __restrict__ partition, int64_t p,
    const int32_t* __restrict__ before_disk, const int32_t* __restrict__ after_disk,
    const uint8_t* __restrict__ before_lead, const uint8_t* __restrict__ after_lead,
    const uint8_t* __restrict__ valid, const float* __restrict__ load_leader,
    const float* __restrict__ load_follower, const int32_t* __restrict__ disk_broker,
    const int32_t* __restrict__ broker_disks, int64_t num_replicas, int64_t num_disks,
    int64_t max_dpb, float* disk_load) {
  constexpr int kThreads = k1::kThreads, kChunks = k1::kChunks;
  __shared__ float s_val[k1::kRows];
  __shared__ int32_t s_slot[k1::kRows];
  __shared__ int32_t s_cnt[kChunks * k1::kWarps];
  const int b = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int t = threadIdx.x;
  const int32_t* disks = broker_disks + b * max_dpb;
  Blend pl{};
  pl.mask = masks + c * p;
  pl.partition = partition;
  pl.p = p;
  float acc = 0.f;  // the load of the broker's t-th disk (t < max_dpb)
  for (int64_t base = 0; base < num_replicas; base += k1::kRows) {
    bool flags[kChunks];
    int slot[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int64_t r = base + k * kThreads + t;
      flags[k] = false;
      slot[k] = -1;
      if (r < num_replicas && valid[r]) {
        const int32_t disk = pl.landed(r) ? after_disk[r] : before_disk[r];
        if (disk >= 0 && disk < num_disks && disk_broker[disk] == b) {
          for (int64_t j = 0; j < max_dpb; ++j)
            if (disks[j] == disk) slot[k] = static_cast<int>(j);
          flags[k] = slot[k] >= 0;
        }
      }
    }
    int pos[kChunks];
    const int total = k1::compact_pass<kChunks>(flags, pos, s_cnt);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (pos[k] < 0) continue;
      const int64_t r = base + k * kThreads + t;
      const bool lead = (pl.landed(r) ? after_lead[r] : before_lead[r]) != 0;
      s_val[pos[k]] = lead ? load_leader[4 * r + 3] : load_follower[4 * r + 3];
      s_slot[pos[k]] = slot[k];
    }
    __syncthreads();
    if (t < max_dpb)
      for (int j = 0; j < total; ++j)
        if (s_slot[j] == t) acc = __fadd_rn(acc, s_val[j]);
    __syncthreads();  // s_val, s_slot and s_cnt are rewritten by the next pass
  }
  if (t < max_dpb && disks[t] >= 0) disk_load[c * num_disks + disks[t]] = acc;
}

__global__ void stack_sweep_batch_kernel(const k9::Args a, const Blend blend) {
  const int64_t g = blockIdx.x;
  const int64_t c = blockIdx.y;
  k9::Args ac = a;
  ac.rc = a.rc + c * a.b;
  ac.lc = a.lc + c * a.b;
  ac.load = a.load + c * a.b * 4;
  ac.pnw = a.pnw + c * a.b;
  ac.lbi = a.lbi + c * a.b;
  if (a.tbc != nullptr) ac.tbc = a.tbc + c * a.t * a.b;
  if (a.tlc != nullptr) ac.tlc = a.tlc + c * a.t * a.b;
  if (a.disk_load != nullptr) ac.disk_load = a.disk_load + c * a.d;
  Blend pl = blend;
  pl.mask = blend.mask + c * blend.p;
  k9::sweep_goal(ac, g, pl, a.sat + c * a.g + g);
}

}  // namespace

extern "C" int cc_blend_aggregates(
    int64_t c, int64_t b, int64_t r, int64_t p, int64_t t, const uint8_t* masks,
    const int32_t* partition, const int32_t* before_rb, const int32_t* after_rb,
    const uint8_t* before_lead, const uint8_t* after_lead, const uint8_t* valid,
    const float* load_leader, const float* load_follower, const int32_t* topic,
    float* load, int32_t* replica_count, int32_t* leader_count, float* potential_nw_out,
    float* leader_bytes_in, int32_t* topic_counts, int32_t* topic_leaders,
    cudaStream_t stream) {
  if (c <= 0 || b <= 0) return 0;
  if (p <= 0 || c > 65535 || ((topic_counts || topic_leaders) && !topic))
    return static_cast<int>(cudaErrorInvalidValue);
  blend_aggregates_kernel<<<dim3(static_cast<unsigned>(b), static_cast<unsigned>(c)),
                            k1::kThreads, 0, stream>>>(
      masks, partition, p, before_rb, after_rb, before_lead, after_lead, valid, load_leader,
      load_follower, topic, r, b, t, load, replica_count, leader_count, potential_nw_out,
      leader_bytes_in, topic_counts, topic_leaders);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_blend_disk_load(
    int64_t c, int64_t b, int64_t r, int64_t p, int64_t d, int64_t max_dpb,
    const uint8_t* masks, const int32_t* partition, const int32_t* before_disk,
    const int32_t* after_disk, const uint8_t* before_lead, const uint8_t* after_lead,
    const uint8_t* valid, const float* load_leader, const float* load_follower,
    const int32_t* disk_broker, const int32_t* broker_disks, float* disk_load,
    cudaStream_t stream) {
  if (c <= 0 || b <= 0) return 0;
  if (p <= 0 || c > 65535 || max_dpb < 1 || max_dpb > k1::kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  blend_disk_load_kernel<<<dim3(static_cast<unsigned>(b), static_cast<unsigned>(c)),
                           k1::kThreads, 0, stream>>>(
      masks, partition, p, before_disk, after_disk, before_lead, after_lead, valid,
      load_leader, load_follower, disk_broker, broker_disks, r, d, max_dpb, disk_load);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_stack_sweep_batch(
    int64_t c, int64_t g, int64_t b, int64_t r, int64_t t, int64_t p, int64_t max_rf,
    int64_t num_racks, const int32_t* ints, const float* floats, const uint8_t* alive,
    const uint8_t* valid, const int32_t* rc, const int32_t* lc, const float* load,
    const float* cap, const float* pnw, const float* lbi, const int32_t* num_alive,
    const int32_t* tbc, const int32_t* tlc, const uint8_t* designated,
    const uint8_t* masks, const int32_t* before_rb, const int32_t* after_rb,
    const uint8_t* before_lead, const uint8_t* after_lead, const int32_t* before_disk,
    const int32_t* after_disk, const float* disk_capacity, const uint8_t* replica_offline,
    const int32_t* original_broker, const int8_t* broker_state,
    const uint8_t* replica_valid, const int32_t* replica_partition,
    const int32_t* partition_replicas, const int32_t* broker_rack,
    const int32_t* partition_rf, uint8_t* sat, int64_t d, int64_t max_dpb,
    const float* disk_capacity_rows, const uint8_t* disk_valid, const int32_t* broker_disks,
    const float* disk_load, cudaStream_t stream) {
  if (c <= 0 || g <= 0) return 0;
  if (b <= 0 || b > 32 * k9::kThreads || p <= 0 || c > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  k9::Args a;
  a.g = g;
  a.b = b;
  a.r = r;
  a.t = t;
  a.max_rf = max_rf;
  a.num_racks = num_racks;
  a.ints = ints;
  a.floats = floats;
  a.alive = alive;
  a.valid = valid;
  a.rc = rc;
  a.lc = lc;
  a.load = load;
  a.cap = cap;
  a.pnw = pnw;
  a.lbi = lbi;
  a.num_alive = num_alive;
  a.tbc = tbc;
  a.tlc = tlc;
  a.designated = designated;
  a.partition_rf = partition_rf;
  a.replica_broker = nullptr;  // the blend is read through the mask
  a.replica_valid = replica_valid;
  a.replica_partition = replica_partition;
  a.partition_replicas = partition_replicas;
  a.broker_rack = broker_rack;
  a.broker_state = broker_state;
  a.is_leader = nullptr;  // the blend is read through the mask
  a.offline = nullptr;
  a.sat = sat;
  a.off = nullptr;
  a.d = d;
  a.max_dpb = max_dpb;
  a.disk_load = disk_load;
  a.disk_capacity = disk_capacity_rows;
  a.disk_valid = disk_valid;
  a.broker_disks = broker_disks;
  Blend blend{};
  blend.mask = masks;
  blend.partition = replica_partition;
  blend.p = p;
  blend.before = before_rb;
  blend.after = after_rb;
  blend.before_lead = before_lead;
  blend.after_lead = after_lead;
  blend.before_disk = before_disk;
  blend.after_disk = after_disk;
  blend.disk_capacity = disk_capacity;
  blend.reported_offline = replica_offline;
  blend.valid = replica_valid;
  blend.original = original_broker;
  blend.state = broker_state;
  stack_sweep_batch_kernel<<<dim3(static_cast<unsigned>(g), static_cast<unsigned>(c)),
                             k9::kThreads, 0, stream>>>(a, blend);
  return static_cast<int>(cudaGetLastError());
}
