// K9's per-goal block body and its per-replica and per-cell tests, shared by
// K9's sweep (stack_sweep.cu: the model's own placement and aggregates,
// spread over the grid by axis) and K10's batched sweep (placement_score.cu:
// one block per (goal, blend), on one execution checkpoint's blended
// placement and its slice of the blended aggregates).  See stack_sweep.cu
// for the goal kinds, the parameter table and the float order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ordered.cuh"

namespace k9 {

constexpr int kThreads = 512;
constexpr float kBig = 1e30f;
enum Kind {
  kCapacity = 0, kPotentialNwOut = 1, kReplicaCapacity = 2, kResourceDist = 3,
  kReplicaDist = 4, kLeaderDist = 5, kLeaderBytesIn = 6, kRack = 7, kTopic = 8,
  kRackDist = 9, kPreferred = 10, kMinLeaders = 11, kIntraCap = 12, kIntraDist = 13
};
constexpr int kNwOut = 2;  // Resource.NW_OUT
constexpr int8_t kDead = 1, kDemoted = 3;  // BrokerState

struct Args {
  int64_t g, b, r, t, max_rf, num_racks;
  const int32_t* ints;   // [G, 3]: kind, resource, is_hard
  const float* floats;   // [G, 4]: eps, a, b, c
  const uint8_t *alive, *valid;
  const int32_t *rc, *lc;
  const float *load, *cap, *pnw, *lbi;
  const int32_t* num_alive;
  const int32_t* tbc;  // [T, B] or null
  const int32_t* tlc;  // [T, B] topic leader counts or null
  const uint8_t* designated;  // [T] or null
  const int32_t* partition_rf;  // [P] replication factors or null
  const int32_t *replica_broker;
  const uint8_t* replica_valid;
  const int32_t *replica_partition, *partition_replicas, *broker_rack;
  const int8_t* broker_state;
  const uint8_t* is_leader;
  // K9's offline test (replica_offline_now): each replica's disk (-1 off
  // JBOD), its reported-offline flag and its broker at model build; K10
  // reads its blend's through the mask instead.
  const int32_t* replica_disk;
  const uint8_t* replica_offline;
  const int32_t* original_broker;
  uint8_t *sat, *off;
  // The disk axis (kinds 12-13): D disks, each broker's disks in increasing
  // order in broker_disks[B, max_dpb] (-1 pad), the disk loads (null unless
  // a disk kind is in the stack).
  int64_t d, max_dpb;
  const float *disk_load, *disk_capacity;
  const uint8_t* disk_valid;
  const int32_t* broker_disks;
};

// alive[i] ? x[stride * i + col] : 0 — a masked column of a broker table.
struct AliveColumn {
  const float* x;
  int64_t stride, col;
  const uint8_t* alive;
  __device__ float operator()(int64_t i) const {
    return alive[i] ? x[stride * i + col] : 0.f;
  }
};

__device__ inline long long block_sum_i(long long v, long long* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) sh[t] += sh[t + stride];
    __syncthreads();
  }
  const long long out = sh[0];
  __syncthreads();
  return out;
}

// The model's own placement (K9): replica r sits on replica_broker[r] and
// leads when is_leader[r]; it is offline as TensorClusterModel.
// replica_offline_now computes it: valid and on a DEAD broker, or on a dead
// disk (capacity < 0), or reported offline and still on its original broker.
struct Direct {
  const int32_t *replica_broker, *replica_disk, *original_broker;
  const uint8_t *is_leader, *replica_valid, *replica_offline;
  const int8_t* broker_state;
  const float* disk_capacity;
  __device__ __forceinline__ int32_t broker(int64_t r) const { return replica_broker[r]; }
  __device__ __forceinline__ bool leader(int64_t r) const { return is_leader[r] != 0; }
  __device__ __forceinline__ bool offline_now(int64_t r) const {
    if (!replica_valid[r]) return false;
    const int32_t b = replica_broker[r];
    const int32_t disk = replica_disk[r];
    const bool dead_disk = disk >= 0 && disk_capacity[disk] < 0.f;
    const bool sticky = replica_offline[r] && b == original_broker[r];
    return broker_state[b] == kDead || dead_disk || sticky;
  }
};

__device__ __forceinline__ Direct direct(const Args& a) {
  return Direct{a.replica_broker, a.replica_disk, a.original_broker, a.is_leader,
                a.replica_valid, a.replica_offline, a.broker_state, a.disk_capacity};
}

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// Broker b's excess over its disks' bands (goals/kernels.py:89-101 with
// _disk_limits :147-171): for the distribution kind the broker's mean
// utilization avg = (load of its live disks) / max(their capacity, 1e-9),
// each disk's band [avg * pb * cap, avg * pa * cap] with cap =
// max(capacity, 1e-9); for the capacity kind [0, cap * pa].  A disk adds
// its deviation from the band, a dead disk (capacity < 0) its whole load,
// an invalid disk nothing.  Every sum runs over the broker's disks in disk
// order, the plain version's index_add_ order.
__device__ inline float broker_disk_excess(const Args& a, int kind, int64_t b, float pa,
                                           float pb) {
  const int32_t* disks = a.broker_disks + b * a.max_dpb;
  float avg = 0.f;
  if (kind == kIntraDist) {
    float load = 0.f, cap = 0.f;
    for (int64_t j = 0; j < a.max_dpb; ++j) {
      const int32_t d = disks[j];
      if (d < 0 || !a.disk_valid[d] || !(a.disk_capacity[d] > 0.f)) continue;
      load = __fadd_rn(load, a.disk_load[d]);
      cap = __fadd_rn(cap, a.disk_capacity[d]);
    }
    avg = __fdiv_rn(load, fmaxf(cap, 1e-9f));
  }
  float excess = 0.f;
  for (int64_t j = 0; j < a.max_dpb; ++j) {
    const int32_t d = disks[j];
    if (d < 0 || !a.disk_valid[d]) continue;
    const float capacity = a.disk_capacity[d];
    const float load = a.disk_load[d];
    float dev;
    if (capacity < 0.f) {
      dev = load;
    } else {
      const float cap = fmaxf(capacity, 1e-9f);
      const float up = kind == kIntraCap ? __fmul_rn(cap, pa) : __fmul_rn(__fmul_rn(avg, pa), cap);
      const float lo = kind == kIntraCap ? 0.f : __fmul_rn(__fmul_rn(avg, pb), cap);
      dev = __fadd_rn(clamp0(__fsub_rn(load, up)), clamp0(__fsub_rn(lo, load)));
    }
    excess = __fadd_rn(excess, dev);
  }
  return excess;
}

// ceil(rf / num_racks) as the plain version computes it (f32).
__device__ __forceinline__ float rack_quota(int32_t rf, int64_t num_racks) {
  return ceilf(__fdiv_rn(static_cast<float>(rf), static_cast<float>(num_racks)));
}

// A dead broker that still hosts replicas: it violates every hard goal.
__device__ __forceinline__ bool dead_hosting(const Args& a, int64_t i) {
  return !a.alive[i] && a.valid[i] && a.rc[i] > 0;
}

// Whether replica i violates a replica-axis goal (kind kRack, kRackDist or
// kPreferred) under placement pl.
template <class Placement>
__device__ __forceinline__ bool replica_violates(const Args& a, int kind, const Placement& pl,
                                                 int64_t i) {
  if (!a.replica_valid[i]) return false;
  const int32_t own = pl.broker(i);
  if (kind == kPreferred) {
    // A wrong leader on an alive broker: a valid leader whose partition's
    // preferred replica is another valid, online replica off a DEMOTED
    // broker, or any leader on a DEMOTED broker.
    if (!pl.leader(i) || !a.alive[own]) return false;
    const int32_t preferred = a.partition_replicas[a.replica_partition[i] * a.max_rf];
    const int32_t sp = preferred > 0 ? preferred : 0;
    const bool pref_ok = preferred >= 0 && a.replica_valid[sp] && !pl.offline_now(sp) &&
                         a.broker_state[pl.broker(sp)] != kDemoted;
    return (preferred != i && pref_ok) || a.broker_state[own] == kDemoted;
  }
  // A replica conflicts when it has a lower-id sibling on its rack (rack),
  // or at least the quota of them (rack_distribution).
  if (!a.alive[own]) return false;
  const int32_t rack = a.broker_rack[own];
  const int64_t p = a.replica_partition[i];
  const int32_t* sib = a.partition_replicas + p * a.max_rf;
  int rank = 0;
  for (int64_t j = 0; j < a.max_rf; ++j) {
    const int32_t s = sib[j];
    rank += s >= 0 && s < i && a.broker_rack[pl.broker(s)] == rack;
  }
  return kind == kRack ? rank > 0
                       : static_cast<float>(rank) >= rack_quota(a.partition_rf[p], a.num_racks);
}

// The topic goal's band of one topic from its replica total: floor / ceil
// of the topic average over alive brokers times (b, a).
struct TopicBand {
  float lower, upper;
  // Whether (topic tp, broker i) is an alive broker out of the band.
  __device__ __forceinline__ bool out(const Args& a, int64_t tp, int64_t i) const {
    const float c = static_cast<float>(a.tbc[tp * a.b + i]);
    return a.alive[i] && (c > upper || c < lower);
  }
};

__device__ __forceinline__ TopicBand topic_band(long long total, float num_alive, float pa,
                                                float pb) {
  const float avg = __fdiv_rn(static_cast<float>(total), num_alive);
  return TopicBand{floorf(__fmul_rn(avg, pb)), ceilf(__fmul_rn(avg, pa))};
}

// An alive broker short of leaders in a designated topic: its shortfall is
// an integer-valued sum, positive when any term is.
__device__ __forceinline__ bool short_of_leaders(const Args& a, int64_t tp, int64_t i,
                                                 float minimum) {
  return a.alive[i] && a.designated[tp] && static_cast<float>(a.tlc[tp * a.b + i]) < minimum;
}

// Goal ``g``'s satisfied flag under placement ``pl`` (read by the rack,
// rack-distribution and preferred-leader kinds; every other kind reads the
// aggregates in ``a``), written to ``sat[0]`` by thread 0.  Every thread
// of the block calls it.
template <class Placement>
__device__ void sweep_goal(const Args& a, int64_t g, const Placement& pl, uint8_t* sat) {
  __shared__ float shf[kThreads];
  __shared__ float sum_out[1];
  __shared__ long long shi[kThreads];
  __shared__ int violated;
  const int t = threadIdx.x;
  if (t == 0) violated = 0;
  __syncthreads();
  const int kind = a.ints[3 * g];
  const int res = a.ints[3 * g + 1];
  const bool hard = a.ints[3 * g + 2] != 0;
  const float eps = a.floats[4 * g];
  const float pa = a.floats[4 * g + 1], pb = a.floats[4 * g + 2], pc = a.floats[4 * g + 3];
  const float num_alive = static_cast<float>(a.num_alive[0]);
  bool any = false;
  // Dead brokers still hosting replicas violate every hard goal.
  if (hard) {
    for (int64_t i = t; i < a.b; i += kThreads) any |= dead_hosting(a, i);
  }
  if (kind == kRack || kind == kRackDist || kind == kPreferred) {
    for (int64_t i = t; i < a.r; i += kThreads) any |= replica_violates(a, kind, pl, i);
  } else if (kind == kMinLeaders) {
    for (int64_t i = t; i < a.t * a.b; i += kThreads)
      any |= short_of_leaders(a, i / a.b, i % a.b, pa);
  } else if (kind == kIntraCap || kind == kIntraDist) {
    // A broker violates when its disks' summed excess leaves [0 - eps, 0 +
    // eps] (the zero band of goals/kernels.py:216-219).
    for (int64_t i = t; i < a.b; i += kThreads) {
      const float excess = broker_disk_excess(a, kind, i, pa, pb);
      any |= a.alive[i] && (excess > eps || excess < -eps);
    }
  } else if (kind == kTopic) {
    // Topic totals are the row sums of the counts (every valid replica is
    // counted at its broker); the excess of a broker is an integer sum, so
    // "metric > 1e-6" is "some topic out of its band".
    for (int64_t tp = 0; tp < a.t; ++tp) {
      long long part = 0;
      for (int64_t i = t; i < a.b; i += kThreads) part += a.tbc[tp * a.b + i];
      const TopicBand band = topic_band(block_sum_i(part, shi), num_alive, pa, pb);
      for (int64_t i = t; i < a.b; i += kThreads) any |= band.out(a, tp, i);
    }
  } else {
    long long si = 0;
    for (int64_t i = t; i < a.b; i += kThreads) {
      if (!a.alive[i]) continue;
      if (kind == kReplicaDist) {
        si += a.rc[i];
      } else if (kind == kLeaderDist) {
        si += a.lc[i];
      }
    }
    float avg_pct = 0.f, avg = 0.f;
    bool gated = false;
    if (kind == kResourceDist) {
      const float util =
          ordered::block_sum(AliveColumn{a.load, 4, res, a.alive}, a.b, shf, sum_out);
      const float capsum = fmaxf(
          ordered::block_sum(AliveColumn{a.cap, 4, res, a.alive}, a.b, shf, sum_out),
          1e-9f);
      avg_pct = __fdiv_rn(util, capsum);
      gated = avg_pct <= pc;
    } else if (kind == kLeaderBytesIn) {
      avg = __fdiv_rn(
          ordered::block_sum(AliveColumn{a.lbi, 1, 0, a.alive}, a.b, shf, sum_out),
          num_alive);
    } else if (kind == kReplicaDist || kind == kLeaderDist) {
      avg = __fdiv_rn(static_cast<float>(block_sum_i(si, shi)), num_alive);
    }
    for (int64_t i = t; i < a.b; i += kThreads) {
      float metric, lower = 0.f, upper;
      switch (kind) {
        case kCapacity:
          metric = a.load[4 * i + res];
          upper = __fmul_rn(a.cap[4 * i + res], pa);
          break;
        case kPotentialNwOut:
          metric = a.pnw[i];
          upper = __fmul_rn(a.cap[4 * i + kNwOut], pa);
          break;
        case kReplicaCapacity:
          metric = static_cast<float>(a.rc[i]);
          upper = pa;
          break;
        case kResourceDist: {
          metric = a.load[4 * i + res];
          const float c = a.cap[4 * i + res];
          upper = gated ? kBig : __fmul_rn(__fmul_rn(avg_pct, pa), c);
          lower = gated ? 0.f : fmaxf(__fmul_rn(__fmul_rn(avg_pct, pb), c), 0.f);
          break;
        }
        case kReplicaDist:
        case kLeaderDist:
          metric = static_cast<float>(kind == kReplicaDist ? a.rc[i] : a.lc[i]);
          upper = ceilf(__fmul_rn(avg, pa));
          lower = floorf(__fmul_rn(avg, pb));
          break;
        default:  // kLeaderBytesIn
          metric = a.lbi[i];
          upper = __fmul_rn(avg, pa);
      }
      const bool out = metric > __fadd_rn(upper, eps) || metric < __fsub_rn(lower, eps);
      any |= a.alive[i] && out;
    }
  }
  if (any) violated = 1;
  __syncthreads();
  if (t == 0) sat[0] = violated == 0;
}

}  // namespace k9
