// K9, sweep — every goal's satisfied flag and the offline flag in one launch
// spread over the grid.
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
// every leader's preferred replica, its broker state and the inputs of its
// offline test, the topic goals the [T, B] counts, the offline flag every
// replica's broker, disk, reported flag and original broker (~R x 14
// bytes): the stack's 16 goals move ~3-5 MB, about a microsecond at 3.35
// TB/s, so the launch and the chains of dependent loads are the cost.  The
// disk kinds read D disk loads, capacities and flags and the B x max_dpb
// disk lists (~13 bytes a disk).
//
// Design: one launch spread over the grid by axis, after two memsets (every
// flag satisfied, no replica offline):
//   - a broker-axis goal (kinds 0-6, 12, 13) takes one block, the per-goal
//     body k9::sweep_goal (stack_sweep.cuh): its alive float sums in the
//     windowed order of ordered.cuh (ops/order.py ordered_sum), as the
//     plain version takes them, so the band edges are the same bits; its
//     integer sums exactly; then every thread tests its brokers and the
//     block writes the goal's flag;
//   - a replica-axis goal (7 rack, 9 rack distribution, 10 preferred
//     leader) takes ceil(R / kTile) blocks, each kPer replicas a thread;
//   - a (topic, broker) goal (8 topic distribution, 11 min topic leaders)
//     takes a warp a topic, kTopicWarps topics a block: the warp sums the
//     topic's counts with shuffles (integers: exact) and tests its brokers;
//   - the offline flag takes ceil(R / kTile) blocks that test each
//     replica's replica_offline_now in the kernel (on a DEAD broker or a
//     dead disk, or reported offline and still on its original broker).
// A hard goal's dead brokers still hosting replicas are tested by its first
// block.  A block that finds a violation stores false into its goal's flag
// (true into the offline flag), one store a warp: every store writes the
// same value, so the flags do not depend on the order in which blocks run
// or finish, and two launches give the same flags.  No host sync, no
// scratch: the launch is captured into the step graphs as it is.  Which
// goal a block serves comes from the kinds in the parameter table (a
// ballot over the goals) and the per-axis goal counts the wrapper passes.
// The per-goal body is also K10's batched sweep's (placement_score.cu), with
// a batch axis.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stack_sweep.cuh"

namespace {

using k9::Args;
constexpr int kThreads = k9::kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPer = 4;                            // replicas a thread
constexpr int64_t kTile = int64_t{kThreads} * kPer;  // replicas a block
constexpr int kTopicWarps = kThreads / 32;         // topics a block
constexpr int kUnroll = 8;                         // a lane's cells of a topic in flight
constexpr int64_t kMaxGoals = 1024;

enum Axis { kBrokerAxis = 0, kReplicaAxis = 1, kTopicAxis = 2 };

__device__ __forceinline__ int axis_of(int kind) {
  if (kind == k9::kRack || kind == k9::kRackDist || kind == k9::kPreferred) return kReplicaAxis;
  if (kind == k9::kTopic || kind == k9::kMinLeaders) return kTopicAxis;
  return kBrokerAxis;
}

// The index of the n-th goal on ``axis`` in the table's order.  Every lane
// of the calling warp calls it and gets the same index.
__device__ int nth_goal(const Args& a, int axis, int64_t n) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = 0; base < a.g; base += 32) {
    const int64_t g = base + lane;
    unsigned m = __ballot_sync(kFull, g < a.g && axis_of(a.ints[3 * g]) == axis);
    const int c = __popc(m);
    if (n < c) {
      for (int64_t k = 0; k < n; ++k) m &= m - 1;  // drop the n lower goals
      return static_cast<int>(base + __ffs(m) - 1);
    }
    n -= c;
  }
  return -1;
}

// Stores ``value`` into ``*flag`` when some thread of the warp found ``hit``.
__device__ __forceinline__ void warp_store(bool hit, uint8_t* flag, uint8_t value) {
  if (__any_sync(kFull, hit) && (threadIdx.x & 31) == 0) *flag = value;
}

// Dead brokers still hosting replicas, for the first block of a hard goal
// that is not on the broker axis (sweep_goal tests its own).
__device__ bool hard_violated(const Args& a, int64_t g) {
  bool any = false;
  if (a.ints[3 * g + 2] != 0)
    for (int64_t i = threadIdx.x; i < a.b; i += kThreads) any |= k9::dead_hosting(a, i);
  return any;
}

__global__ void __launch_bounds__(kThreads) stack_sweep_kernel(
    const Args a, int64_t replica_goals, int64_t topic_goals, int64_t replica_tiles,
    int64_t topic_tiles) {
  const k9::Direct pl = k9::direct(a);
  const int t = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int64_t broker_goals = a.g - replica_goals - topic_goals;
  if (blk < broker_goals) {
    const int g = nth_goal(a, kBrokerAxis, blk);
    k9::sweep_goal(a, g, pl, a.sat + g);
    return;
  }
  blk -= broker_goals;
  if (blk < replica_goals * replica_tiles) {
    const int64_t tile = blk % replica_tiles;
    const int g = nth_goal(a, kReplicaAxis, blk / replica_tiles);
    const int kind = a.ints[3 * g];
    bool any = tile == 0 && hard_violated(a, g);
    const int64_t first = tile * kTile + t;
    bool hit[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t i = first + int64_t{k} * kThreads;
      hit[k] = i < a.r && k9::replica_violates(a, kind, pl, i);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) any |= hit[k];
    warp_store(any, a.sat + g, 0);
    return;
  }
  blk -= replica_goals * replica_tiles;
  if (blk < topic_goals * topic_tiles) {
    const int64_t tile = blk % topic_tiles;
    const int g = nth_goal(a, kTopicAxis, blk / topic_tiles);
    const int kind = a.ints[3 * g];
    const float pa = a.floats[4 * g + 1], pb = a.floats[4 * g + 2];
    bool any = tile == 0 && hard_violated(a, g);
    const int lane = t & 31;
    const int64_t tp = tile * kTopicWarps + (t >> 5);
    if (tp < a.t) {  // the whole warp; kUnroll cells of a lane in flight at once
      if (kind == k9::kTopic) {
        long long part = 0;
        for (int64_t base = lane; base < a.b; base += 32 * kUnroll) {
          int32_t c[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int64_t i = base + 32 * u;
            c[u] = i < a.b ? a.tbc[tp * a.b + i] : 0;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) part += c[u];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
        const k9::TopicBand band =
            k9::topic_band(part, static_cast<float>(a.num_alive[0]), pa, pb);
        for (int64_t base = lane; base < a.b; base += 32 * kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int64_t i = base + 32 * u;
            any |= i < a.b && band.out(a, tp, i);
          }
        }
      } else {
        for (int64_t base = lane; base < a.b; base += 32 * kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int64_t i = base + 32 * u;
            any |= i < a.b && k9::short_of_leaders(a, tp, i, pa);
          }
        }
      }
    }
    warp_store(any, a.sat + g, 0);
    return;
  }
  blk -= topic_goals * topic_tiles;
  // The offline flag: tile ``blk`` of the replicas.
  const int64_t first = blk * kTile + t;
  bool hit[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = first + int64_t{k} * kThreads;
    hit[k] = i < a.r && pl.offline_now(i);
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) any |= hit[k];
  warp_store(any, a.off, 1);
}

}  // namespace

// K9's sweep: g goals of the table (ints, floats), of which replica_goals
// are of a replica-axis kind (7, 9, 10) and topic_goals of a (topic, broker)
// kind (8, 11); sat (bool[g]) and off (bool[1]) are written.
extern "C" int cc_stack_sweep(
    int64_t g, int64_t b, int64_t r, int64_t t, int64_t max_rf, int64_t num_racks,
    int64_t replica_goals, int64_t topic_goals, const int32_t* ints, const float* floats,
    const uint8_t* alive, const uint8_t* valid, const int32_t* rc, const int32_t* lc,
    const float* load, const float* cap, const float* pnw, const float* lbi,
    const int32_t* num_alive, const int32_t* tbc, const int32_t* tlc,
    const uint8_t* designated, const int32_t* partition_rf, const int32_t* replica_broker,
    const uint8_t* replica_valid, const int32_t* replica_partition,
    const int32_t* partition_replicas, const int32_t* broker_rack, const int8_t* broker_state,
    const uint8_t* is_leader, const int32_t* replica_disk, const uint8_t* replica_offline,
    const int32_t* original_broker, uint8_t* sat, uint8_t* off, int64_t d, int64_t max_dpb,
    const float* disk_capacity, const uint8_t* disk_valid, const int32_t* broker_disks,
    const float* disk_load, cudaStream_t stream) {
  if (g < 0 || g > kMaxGoals || b <= 0 || b > 32 * kThreads || r < 0 || t < 0 ||
      replica_goals < 0 || topic_goals < 0 || replica_goals + topic_goals > g)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.replica_disk = replica_disk;
  a.replica_offline = replica_offline;
  a.original_broker = original_broker;
  a.sat = sat;
  a.off = off;
  a.d = d;
  a.max_dpb = max_dpb;
  a.disk_load = disk_load;
  a.disk_capacity = disk_capacity;
  a.disk_valid = disk_valid;
  a.broker_disks = broker_disks;
  const int64_t replica_tiles = r > 0 ? (r + kTile - 1) / kTile : 1;
  const int64_t topic_tiles = t > 0 ? (t + kTopicWarps - 1) / kTopicWarps : 1;
  const int64_t blocks = (g - replica_goals - topic_goals) + replica_goals * replica_tiles +
                         topic_goals * topic_tiles + replica_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = g > 0 ? cudaMemsetAsync(sat, 1, static_cast<size_t>(g), stream)
                          : cudaSuccess;
  if (err == cudaSuccess) err = cudaMemsetAsync(off, 0, 1, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  stack_sweep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, replica_goals, topic_goals, replica_tiles, topic_tiles);
  return static_cast<int>(cudaGetLastError());
}
