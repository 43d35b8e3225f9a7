// K9, sweep — every goal's satisfied flag and the offline flag in one launch.
//
// Replaces cruise_control_tpu/analyzer/optimizer.py:2332 _stack_satisfied:
// goals/kernels.py:237 goal_satisfied (``violated_brokers(...).any()``, :185)
// for each of G goals, plus ``any_offline`` (offline replicas remain).  A
// broker violates a goal when it is alive and its metric lies outside
// [lower - eps, upper + eps], or, for a hard goal, when it is dead and still
// hosts replicas.  Goal kinds (column 0 of ``ints``, the order of
// kernels._SWEEP_KINDS):
//   0 capacity            load[:, res] against cap[:, res] * a
//   1 potential_nw_out    potential NW_OUT against cap[:, NW_OUT] * a
//   2 replica_capacity    replica count against a
//   3 resource_distribution  load[:, res] against avg_pct * {b, a} * cap,
//                         avg_pct = alive load sum / alive capacity sum,
//                         unbounded while avg_pct <= c
//   4 replica_distribution   replica count against floor / ceil(avg * {b, a})
//   5 leader_replica_distribution  the same on leader counts
//   6 leader_bytes_in     leader bytes-in against avg * a
//   7 rack                replicas that share a rack with a lower-id
//                         sibling of their partition (must be none)
//   8 topic_replica_distribution  per (topic, broker) replica counts
//                         against floor / ceil(topic average * {b, a})
//   9 rack_distribution   replicas with at least ceil(rf / num_racks)
//                         lower-id siblings of their partition on their
//                         rack (must be none)
//  10 preferred_leader    wrong leaders (must be none): a valid leader
//                         whose partition's preferred replica is another
//                         valid, online replica off a DEMOTED broker, or
//                         any leader on a DEMOTED broker
//  11 min_topic_leaders   (topic, broker) leader counts of designated
//                         topics on alive brokers against a (the minimum)
//  12 intra_disk_capacity  each broker's summed excess of its disks over
//                         [0, capacity * a] (a dead disk: its whole load)
//                         against 0 +- eps
//  13 intra_disk_distribution  the same over [avg * b * cap, avg * a *
//                         cap], avg the broker's mean disk utilization
// ``floats`` holds (eps, a, b, c) per goal as float32, which is how torch
// applies the Python constants of the plain version.
//
// Bound on the card: bytes.  A band goal reads its broker rows once (B x
// ~40 bytes), the rack goal every replica's broker, partition and sibling
// rows (~R x 24 bytes, 2.4 MB at the large rung), the preferred-leader goal
// every leader's preferred replica, its broker state and offline flag (~R x
// 12 bytes), the topic goals the [T, B] counts, the offline block R flags:
// the stack's 16 goals move ~3-5 MB, about a microsecond at 3.35 TB/s — the
// launch costs more than the work.  The disk kinds read D disk loads,
// capacities and flags and the B x max_dpb disk lists (~13 bytes a disk).
//
// Design: one block per goal and one more for the offline flag.  A block
// reduces the alive sums its kind needs — float sums in the windowed order
// of ordered.cuh (ops/order.py ordered_sum), as the plain version does, so
// the band edges are the same bits; integer sums exactly — then every
// thread tests its brokers (or replicas, or (topic, broker) cells) and ORs
// into a shared flag.  The per-goal body is k9::sweep_goal
// (stack_sweep.cuh), which K10's batched sweep (placement_score.cu) calls
// with a batch axis.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stack_sweep.cuh"

namespace {

using k9::Args;
constexpr int kThreads = k9::kThreads;

__global__ void stack_sweep_kernel(const Args a) {
  const int64_t g = blockIdx.x;
  if (g == a.g) {  // the offline block
    __shared__ int violated;
    const int t = threadIdx.x;
    if (t == 0) violated = 0;
    __syncthreads();
    bool any = false;
    for (int64_t i = t; i < a.r; i += kThreads) any |= a.offline[i] && a.replica_valid[i];
    if (any) violated = 1;
    __syncthreads();
    if (t == 0) a.off[0] = violated != 0;
    return;
  }
  k9::sweep_goal(a, g, k9::Direct{a.replica_broker, a.is_leader, a.offline}, a.sat + g);
}

}  // namespace

extern "C" int cc_stack_sweep(
    int64_t g, int64_t b, int64_t r, int64_t t, int64_t max_rf, int64_t num_racks,
    const int32_t* ints, const float* floats, const uint8_t* alive, const uint8_t* valid,
    const int32_t* rc, const int32_t* lc, const float* load, const float* cap,
    const float* pnw, const float* lbi, const int32_t* num_alive, const int32_t* tbc,
    const int32_t* tlc, const uint8_t* designated, const int32_t* partition_rf,
    const int32_t* replica_broker, const uint8_t* replica_valid,
    const int32_t* replica_partition, const int32_t* partition_replicas,
    const int32_t* broker_rack, const int8_t* broker_state, const uint8_t* is_leader,
    const uint8_t* offline, uint8_t* sat, uint8_t* off, int64_t d, int64_t max_dpb,
    const float* disk_capacity, const uint8_t* disk_valid, const int32_t* broker_disks,
    const float* disk_load, cudaStream_t stream) {
  if (g < 0 || b <= 0 || b > 32 * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
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
  a.replica_broker = replica_broker;
  a.replica_valid = replica_valid;
  a.replica_partition = replica_partition;
  a.partition_replicas = partition_replicas;
  a.broker_rack = broker_rack;
  a.broker_state = broker_state;
  a.is_leader = is_leader;
  a.offline = offline;
  a.sat = sat;
  a.off = off;
  a.d = d;
  a.max_dpb = max_dpb;
  a.disk_load = disk_load;
  a.disk_capacity = disk_capacity;
  a.disk_valid = disk_valid;
  a.broker_disks = broker_disks;
  stack_sweep_kernel<<<static_cast<unsigned>(g + 1), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
