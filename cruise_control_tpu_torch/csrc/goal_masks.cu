// K5 — per-candidate score and eligibility of one goal, in one pass.
//
// Replaces cruise_control_tpu/analyzer/goals/kernels.py:550 score, :354
// self_feasible and :256 _candidate_deltas, with the eligible line of
// cruise_control_tpu/analyzer/optimizer.py:1154:
//     eligible = valid & self_feasible & accepted & (score > 1e-9)
// for the goal kinds of the default stack:
//   mode 0, threshold bands (capacity, potential_nw_out, replica_capacity):
//       score = reduction of the summed excess over the upper limit;
//   mode 1, distribution bands (resource_distribution, replica_distribution,
//       leader_replica_distribution, leader_bytes_in): score = reduction of
//       the summed squared deviation from the band midpoint;
//   mode 2, topic_replica_distribution: the same over (topic, broker)
//       replica counts around the topic's average;
//   mode 3, rack: siblings sharing the source rack minus those sharing the
//       destination rack, with a sibling gather over max_rf;
//   mode 4, preferred_leader: a leadership transfer of a wrong leader (a
//       leader whose preferred replica is another valid, online replica
//       off a DEMOTED broker, or any leader on a DEMOTED broker) to the
//       preferred replica (score 1) or off a DEMOTED source (score 0.5);
//   mode 5, min_topic_leaders: a transfer or leader move of a designated
//       topic into a broker short of its leaders without starving the
//       source; the gain into dest and the loss on src, each clamped to 1,
//       from two cells of the [T, B] topic leader counts;
//   mode 6, rack_distribution: mode 3's sibling walk, with the quota
//       ceil(rf / num_racks) in place of "no sibling on the dest rack";
//   mode 7, intra_disk_capacity and intra_disk_distribution (JAX
//       goals/kernels.py:427 _intra_disk_feasible, :578 score): an intra-
//       broker move of the replica's DISK load, or an intra-broker swap's
//       net exchange, from the source disk onto another disk of the same
//       broker; feasible when it helps (source over its band or dead,
//       destination under) and both disks stay legal; the score is the
//       two disks' summed deviation from their bands before minus after,
//       plus the offline bonus off a dead disk.  The disk bands (lo_d,
//       up_d) and the disk loads come in per disk, computed once per step
//       (disk_load by K1's segment_sum[disk], the distribution band's two
//       per-broker sums by segment_sum[disk_broker]).
// The cross-goal vetoes of structural previous goals arrive as the
// ``accepted`` mask (null = all accepted); K5b below computes them.
//
// K5b (cc_structural_accepts) replaces goals/kernels.py:464 accepts of the
// structural previous goals: rack (a move may not land on a rack that holds
// another replica of the partition; a swap checks both legs),
// rack_distribution (the same against the ceil(rf / num_racks) quota),
// topic_replica_distribution (a move or swap may not push a (topic, broker)
// count out of the topic's band) and min_topic_leaders (no transfer, move
// or swap may take a designated leader off an alive broker at the minimum,
// the swap's reverse leg included).  One thread per lane, the same sibling
// walk as modes 3 and 6, the same topic-count rows as mode 2 and the
// leader-count rows of mode 5; exact booleans.  With an earlier intra-broker
// disk goal it also vetoes any action that lands a replica on a disk over
// that goal's upper disk band (goals/kernels.py:492-510): a move onto the
// destination broker's first disk, an intra move, or either leg of an
// inter- or intra-broker swap (the net DISK exchange on each disk).  Bound:
// bytes (~40 per lane through the gathers: 1.3 MB at 32,768 lanes).
//
// Bound on the card: bytes.  A lane reads ~80 bytes through its gathers
// (its own fields, two broker rows, a topic row or max_rf sibling rows) and
// writes 5; at the mid rung's 32,768 lanes that is ~2.7 MB, under a
// microsecond at 3.35 TB/s — one launch instead of the ~60 elementwise
// launches of the torch ops.
//
// Design: one thread per lane.  The arithmetic is the plain version's
// (goal_masks_plain) in its order, with round-to-nearest intrinsics so that
// nvcc contracts nothing on its own; the one fused multiply-add is where the
// plain version has it (_sq_sum: fma(x, x, y * y), as XLA's CPU code
// generator computes the JAX package's squares).  Scalar constants are the
// Python doubles converted to float, as torch converts them.  So the kernel
// and the plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThreshold = 0, kDistribution = 1, kTopic = 2, kRack = 3, kPreferred = 4,
              kMinLeaders = 5, kRackDist = 6, kIntraDisk = 7;
constexpr int32_t kMove = 0;        // ActionType.INTER_BROKER_REPLICA_MOVEMENT
constexpr int32_t kLeadership = 1;  // ActionType.LEADERSHIP_MOVEMENT
constexpr int32_t kIntraMove = 2;   // ActionType.INTRA_BROKER_REPLICA_MOVEMENT
constexpr int32_t kSwap = 3;        // ActionType.INTER_BROKER_REPLICA_SWAP
constexpr int32_t kIntraSwap = 4;   // ActionType.INTRA_BROKER_REPLICA_SWAP
constexpr int kDiskColumn = 3;      // Resource.DISK
constexpr int8_t kDemoted = 3;      // BrokerState.DEMOTED

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// x * x + y * y rounded as fma(x, x, round(y * y)).
__device__ __forceinline__ float sq_sum(float x, float y) {
  return __fmaf_rn(x, x, __fmul_rn(y, y));
}

// The DISK load replica r carries under its current leadership
// (TensorClusterModel.replica_load()[r, DISK]): a pick, no arithmetic.
__device__ __forceinline__ float disk_contrib(const float* leader, const float* follower,
                                              const uint8_t* is_leader, int32_t r) {
  return is_leader[r] ? leader[4 * r + kDiskColumn] : follower[4 * r + kDiskColumn];
}

// A disk's deviation from its band [lo, up] at ``load``.
__device__ __forceinline__ float band_dev(float load, float lo, float up) {
  return __fadd_rn(clamp0(__fsub_rn(load, up)), clamp0(__fsub_rn(lo, load)));
}

// ceil(rf / num_racks) as the plain version computes it: an i32 divided by
// a Python int is f32.
__device__ __forceinline__ float rack_quota(int32_t rf, int64_t num_racks) {
  return ceilf(__fdiv_rn(static_cast<float>(rf), static_cast<float>(num_racks)));
}

struct Args {
  int mode, delta_sel;
  int64_t k, num_brokers, max_rf, need, num_racks;
  float eps;
  const int32_t *action_type, *replica, *src, *dest;
  const uint8_t *valid, *accepted;
  const float *delta_src, *delta_dest;
  const int32_t *d_replica_count, *d_leader_count;
  const float *d_pnw, *d_lbi_src, *d_lbi_dest;
  const uint8_t* alive;
  const float *metric, *lower, *upper;
  const uint8_t* offline_now;
  const int32_t *replica_topic, *replica_partition, *replica_broker;
  const uint8_t* conflict;
  const int32_t* tbc;
  const float *lower_t, *upper_t, *avg_t;
  const int32_t *partition_replicas, *broker_rack;
  float* score;
  uint8_t* eligible;
  const int32_t* dest_replica;
  const int8_t* broker_state;
  const uint8_t *is_leader, *replica_valid;
  const int32_t* tlc;         // [T, B] topic leader counts (mode 5)
  const uint8_t* designated;  // [T] (mode 5)
  const int32_t* partition_rf;  // [P] replication factors (mode 6)
  // Mode 7: per disk the load, the band and the owner broker; per lane
  // the source and destination disks; per replica the load rows.
  const float *disk_load, *lo_d, *up_d, *disk_capacity;
  const int32_t *disk_broker, *src_disk, *dest_disk;
  const float *load_leader, *load_follower;
};

// Replica r leads wrongly (goals/kernels.py:105 _wrong_leader_mask): it is a
// valid leader and its partition's preferred replica is another valid,
// online replica off a DEMOTED broker, or r itself sits on a DEMOTED broker.
__device__ __forceinline__ bool wrong_leader(const Args& a, int32_t r, int32_t preferred) {
  if (!a.is_leader[r] || !a.replica_valid[r]) return false;
  const int32_t sp = preferred > 0 ? preferred : 0;
  const bool pref_ok = preferred >= 0 && a.replica_valid[sp] && !a.offline_now[sp] &&
                       a.broker_state[a.replica_broker[sp]] != kDemoted;
  return (preferred != r && pref_ok) || a.broker_state[a.replica_broker[r]] == kDemoted;
}

__global__ void goal_masks_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.k) return;
  const float kBig = static_cast<float>(1e30);
  const float kBonus = static_cast<float>(1e12);
  const float kMinScore = static_cast<float>(1e-9);
  const int32_t r = a.replica[i];
  const int32_t s = a.src[i];
  const int32_t d = a.dest[i];
  const bool is_move = a.action_type[i] == kMove;
  const bool unhealthy = !a.alive[s] || a.offline_now[r];
  const float bonus = (unhealthy && is_move) ? kBonus : 0.f;
  bool feasible;
  float score;
  if (a.mode == kIntraDisk) {
    const int32_t at = a.action_type[i];
    const bool intra_move = at == kIntraMove, intra_swap = at == kIntraSwap;
    const int32_t sd = a.src_disk[i], dd = a.dest_disk[i];
    const int32_t sc = sd > 0 ? sd : 0, dc = dd > 0 ? dd : 0;  // maximum(disk, 0)
    const int32_t r2 = a.dest_replica[i] >= 0 ? a.dest_replica[i] : 0;
    const float contrib = disk_contrib(a.load_leader, a.load_follower, a.is_leader, r);
    const float contrib2 = disk_contrib(a.load_leader, a.load_follower, a.is_leader, r2);
    const float ls = a.disk_load[sc], ld = a.disk_load[dc];
    const float lo_s = a.lo_d[sc], up_s = a.up_d[sc], lo_t = a.lo_d[dc], up_t = a.up_d[dc];
    const bool src_dead = a.disk_capacity[sc] < 0.f;
    const bool src_over = ls > __fadd_rn(up_s, a.eps);
    const bool dest_under = ld < __fsub_rn(lo_t, a.eps);
    const bool helps = src_over || dest_under || src_dead;
    const bool same_broker = a.disk_broker[dc] == s;
    const bool valid_disks = sd >= 0 && dd >= 0 && sd != dd;
    const bool dest_live = a.disk_capacity[dc] > 0.f;
    const bool common = valid_disks && same_broker && helps && dest_live;
    const bool move_ok = intra_move && common && __fadd_rn(ld, contrib) <= up_t &&
                         (__fsub_rn(ls, contrib) >= lo_s || src_dead || src_over);
    const float net = __fsub_rn(contrib, contrib2);
    const float ls_swap = __fsub_rn(ls, net);
    const bool swap_ok = intra_swap && common && __fadd_rn(ld, net) <= up_t &&
                         (ls_swap >= lo_s || src_dead || src_over) &&
                         (ls_swap <= up_s || net > 0.f);
    feasible = move_ok || swap_ok;
    const float moved = intra_swap ? net : contrib;
    const float before = __fadd_rn(band_dev(ls, lo_s, up_s), band_dev(ld, lo_t, up_t));
    const float after = __fadd_rn(band_dev(__fsub_rn(ls, moved), lo_s, up_s),
                                  band_dev(__fadd_rn(ld, moved), lo_t, up_t));
    score = (intra_move || intra_swap)
                ? __fadd_rn(__fsub_rn(before, after), src_dead ? kBonus : 0.f)
                : 0.f;
  } else if (a.mode == kRack || a.mode == kRackDist) {
    const int32_t p = a.replica_partition[r];
    const int32_t own_rack = a.broker_rack[s];
    const int32_t dest_rack = a.broker_rack[d];
    int before = 0, after = 0;
    for (int64_t j = 0; j < a.max_rf; ++j) {
      const int32_t sib = a.partition_replicas[p * a.max_rf + j];
      if (sib < 0 || sib == r) continue;
      const int32_t rack = a.broker_rack[a.replica_broker[sib]];
      before += rack == own_rack;
      after += rack == dest_rack;
    }
    const bool dest_ok = a.mode == kRack
                             ? after == 0
                             : static_cast<float>(1 + after) <=
                                   rack_quota(a.partition_rf[p], a.num_racks);
    feasible = is_move && (a.conflict[r] || unhealthy) && dest_ok;
    score = __fadd_rn(static_cast<float>(before - after), bonus);
  } else if (a.mode == kPreferred) {
    const int32_t preferred = a.partition_replicas[a.replica_partition[r] * a.max_rf];
    const bool to_pref = a.dest_replica[i] == preferred;
    feasible = a.action_type[i] == kLeadership && wrong_leader(a, r, preferred) &&
               (to_pref || a.broker_state[s] == kDemoted);
    score = feasible ? (to_pref ? 1.f : 0.5f) : 0.f;
  } else if (a.mode == kMinLeaders) {
    const int64_t t = a.replica_topic[r];
    const bool designated = a.designated[t] != 0;
    const int32_t ls = a.tlc[t * a.num_brokers + s], ld = a.tlc[t * a.num_brokers + d];
    const bool gains = a.action_type[i] == kLeadership || (is_move && a.is_leader[r]);
    feasible = designated && gains && ld < a.need && (ls - 1 >= a.need || unhealthy);
    const float need = static_cast<float>(a.need);
    const float fs = static_cast<float>(ls), fd = static_cast<float>(ld);
    const float gain = fminf(clamp0(__fsub_rn(need, fd)), 1.f);
    const float loss = __fsub_rn(clamp0(__fsub_rn(need, __fsub_rn(fs, 1.f))),
                                 clamp0(__fsub_rn(need, fs)));
    score = __fadd_rn(designated ? __fsub_rn(gain, fminf(loss, 1.f)) : 0.f, bonus);
  } else if (a.mode == kTopic) {
    const int64_t t = a.replica_topic[r];
    const float cs = static_cast<float>(a.tbc[t * a.num_brokers + s]);
    const float cd = static_cast<float>(a.tbc[t * a.num_brokers + d]);
    const float up = a.upper_t[t], lo = a.lower_t[t], avg = a.avg_t[t];
    const bool helps = cs > up || cd < lo || unhealthy;
    const bool stays = __fadd_rn(cd, 1.f) <= up && (__fsub_rn(cs, 1.f) >= lo || unhealthy);
    feasible = is_move && helps && stays;
    const float before = sq_sum(__fsub_rn(cs, avg), __fsub_rn(cd, avg));
    const float after = sq_sum(__fsub_rn(__fsub_rn(cs, 1.f), avg),
                               __fsub_rn(__fadd_rn(cd, 1.f), avg));
    score = __fadd_rn(__fsub_rn(before, after), bonus);
  } else {
    float d_src, d_dest;
    switch (a.delta_sel) {
      case 4: {
        const float dc = static_cast<float>(a.d_replica_count[i]);
        d_src = -dc;
        d_dest = dc;
        break;
      }
      case 5: {
        const float dl = static_cast<float>(a.d_leader_count[i]);
        d_src = -dl;
        d_dest = dl;
        break;
      }
      case 6:
        d_src = -a.d_pnw[i];
        d_dest = a.d_pnw[i];
        break;
      case 7:
        d_src = -a.d_lbi_src[i];
        d_dest = a.d_lbi_dest[i];
        break;
      default:
        d_src = a.delta_src[4 * i + a.delta_sel];
        d_dest = a.delta_dest[4 * i + a.delta_sel];
    }
    const float src_m = a.metric[s], dest_m = a.metric[d];
    const float up_s = a.upper[s], up_d = a.upper[d];
    const float lo_s = a.lower[s], lo_d = a.lower[d];
    const float src_after = __fadd_rn(src_m, d_src);
    const float dest_after = __fadd_rn(dest_m, d_dest);
    const bool src_over = src_m > __fadd_rn(up_s, a.eps);
    const bool dest_under = dest_m < __fsub_rn(lo_d, a.eps);
    const bool helps = src_over || dest_under || unhealthy;
    const bool dest_ok = dest_after <= up_d;
    const bool src_ok = src_after >= lo_s || unhealthy;
    feasible = helps && dest_ok && src_ok && fabsf(d_dest) > 0.f;
    float before, after;
    if (a.mode == kThreshold) {
      before = __fadd_rn(clamp0(__fsub_rn(src_m, up_s)), clamp0(__fsub_rn(dest_m, up_d)));
      after = __fadd_rn(clamp0(__fsub_rn(src_after, up_s)),
                        clamp0(__fsub_rn(dest_after, up_d)));
    } else {
      const float t_s = up_s >= kBig ? src_m : __fmul_rn(__fadd_rn(lo_s, up_s), 0.5f);
      const float t_d = up_d >= kBig ? dest_m : __fmul_rn(__fadd_rn(lo_d, up_d), 0.5f);
      before = sq_sum(__fsub_rn(src_m, t_s), __fsub_rn(dest_m, t_d));
      after = sq_sum(__fsub_rn(src_after, t_s), __fsub_rn(dest_after, t_d));
    }
    score = __fadd_rn(__fsub_rn(before, after), bonus);
  }
  a.score[i] = score;
  a.eligible[i] = a.valid[i] && feasible && (a.accepted == nullptr || a.accepted[i]) &&
                  score > kMinScore;
}

struct AcceptArgs {
  int rack, rack_dist, topic, min_leaders, intra_cap, intra_dist;
  int64_t k, num_brokers, max_rf, need, num_racks;
  const int32_t *action_type, *replica, *src, *dest, *dest_replica;
  const int32_t *replica_topic, *replica_partition, *replica_broker;
  const int32_t *partition_replicas, *broker_rack, *tbc;
  const float *lower_t, *upper_t;
  const uint8_t *is_leader, *alive;
  const int32_t* tlc;
  const uint8_t* designated;
  const int32_t* partition_rf;
  uint8_t* out;
  // The disk vetoes: the disk loads, each earlier disk goal's upper band
  // (null when that goal is not in the stack), the lanes' disks and the
  // replicas' load rows.
  const float *disk_load, *up_cap, *up_dist;
  const int32_t *src_disk, *dest_disk;
  const float *load_leader, *load_follower;
};

// An earlier disk goal with upper band ``up`` does not veto the lane
// (goals/kernels.py:492-510): no landing pushes a disk over the band.
__device__ __forceinline__ bool disk_leg_ok(const AcceptArgs& a, const float* up,
                                            bool changes_disk, bool any_swap, int32_t sd,
                                            int32_t sc, int32_t dc, float net_in, float c1,
                                            float c2) {
  const bool over = __fadd_rn(a.disk_load[dc], net_in) > up[dc];
  const bool over_rev = any_swap && sd >= 0 &&
                        __fsub_rn(__fadd_rn(a.disk_load[sc], c2), c1) > up[sc];
  return !((changes_disk && over) || over_rev);
}

// Siblings of replica r's partition (other than r) on rack ``rack``.
__device__ __forceinline__ int siblings_on(const AcceptArgs& a, int32_t r, int32_t rack) {
  const int32_t* sib = a.partition_replicas + a.replica_partition[r] * a.max_rf;
  int n = 0;
  for (int64_t j = 0; j < a.max_rf; ++j) {
    const int32_t s = sib[j];
    n += s >= 0 && s != r && a.broker_rack[a.replica_broker[s]] == rack;
  }
  return n;
}

// Moving replica r onto rack ``rack`` keeps the rack goals of the stack:
// no sibling there (rack), at most the quota with r (rack_distribution).
__device__ __forceinline__ bool rack_leg_ok(const AcceptArgs& a, int32_t r, int32_t rack) {
  const int n = siblings_on(a, r, rack);
  bool ok = !a.rack || n == 0;
  if (a.rack_dist)
    ok = ok && static_cast<float>(1 + n) <=
                   rack_quota(a.partition_rf[a.replica_partition[r]], a.num_racks);
  return ok;
}

__global__ void structural_accepts_kernel(const AcceptArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.k) return;
  const int32_t at = a.action_type[i];
  const bool is_move = at == kMove, is_swap = at == kSwap;
  const int32_t r = a.replica[i], s = a.src[i], d = a.dest[i];
  const int32_t r2 = a.dest_replica[i] >= 0 ? a.dest_replica[i] : 0;
  bool ok = true;
  if (a.min_leaders) {
    // A designated leader leaving an alive broker at the minimum: r off
    // src (a transfer, or a move or swap of a leader), r2 off dest (the
    // swap's reverse leg).
    const int64_t t = a.replica_topic[r], t2 = a.replica_topic[r2];
    const bool loses = at == kLeadership || ((is_move || is_swap) && a.is_leader[r]);
    const bool starves = a.designated[t] && loses &&
                         a.tlc[t * a.num_brokers + s] - 1 < a.need && a.alive[s];
    const bool starves2 = is_swap && a.designated[t2] && a.is_leader[r2] &&
                          a.tlc[t2 * a.num_brokers + d] - 1 < a.need && a.alive[d];
    ok = !(starves || starves2);
  }
  if (a.intra_cap || a.intra_dist) {
    const bool any_swap = is_swap || at == kIntraSwap;
    const int32_t sd = a.src_disk[i], dd = a.dest_disk[i];
    const int32_t sc = sd > 0 ? sd : 0, dc = dd > 0 ? dd : 0;
    const float c1 = disk_contrib(a.load_leader, a.load_follower, a.is_leader, r);
    const float c2 = disk_contrib(a.load_leader, a.load_follower, a.is_leader, r2);
    const float net_in = any_swap ? __fsub_rn(c1, c2) : c1;
    const bool changes_disk = (is_move || at == kIntraMove || any_swap) && dd >= 0;
    if (a.intra_cap)
      ok = ok && disk_leg_ok(a, a.up_cap, changes_disk, any_swap, sd, sc, dc, net_in, c1, c2);
    if (a.intra_dist)
      ok = ok && disk_leg_ok(a, a.up_dist, changes_disk, any_swap, sd, sc, dc, net_in, c1, c2);
  }
  if (is_move || is_swap) {
    if (a.rack || a.rack_dist) {
      ok = ok && rack_leg_ok(a, r, a.broker_rack[d]);
      if (is_swap) ok = ok && rack_leg_ok(a, r2, a.broker_rack[s]);
    }
    if (a.topic) {
      const int64_t t = a.replica_topic[r];
      const float cs = static_cast<float>(a.tbc[t * a.num_brokers + s]);
      const float cd = static_cast<float>(a.tbc[t * a.num_brokers + d]);
      bool tok = __fadd_rn(cd, 1.f) <= a.upper_t[t] && __fsub_rn(cs, 1.f) >= a.lower_t[t];
      if (is_swap) {
        const int64_t t2 = a.replica_topic[r2];
        const float c2s = static_cast<float>(a.tbc[t2 * a.num_brokers + s]);
        const float c2d = static_cast<float>(a.tbc[t2 * a.num_brokers + d]);
        tok = tok && __fadd_rn(c2s, 1.f) <= a.upper_t[t2] &&
              __fsub_rn(c2d, 1.f) >= a.lower_t[t2];
      }
      ok = ok && tok;
    }
  }
  a.out[i] = ok;
}

}  // namespace

extern "C" int cc_structural_accepts(
    int64_t rack, int64_t rack_dist, int64_t topic, int64_t min_leaders, int64_t intra_cap,
    int64_t intra_dist, int64_t k,
    int64_t num_brokers, int64_t max_rf, int64_t need, int64_t num_racks,
    const int32_t* action_type, const int32_t* replica, const int32_t* src,
    const int32_t* dest, const int32_t* dest_replica, const int32_t* replica_topic,
    const int32_t* replica_partition, const int32_t* replica_broker,
    const int32_t* partition_replicas, const int32_t* broker_rack, const int32_t* tbc,
    const float* lower_t, const float* upper_t, const uint8_t* is_leader,
    const uint8_t* alive, const int32_t* tlc, const uint8_t* designated,
    const int32_t* partition_rf, uint8_t* out, const float* disk_load, const float* up_cap,
    const float* up_dist, const int32_t* src_disk, const int32_t* dest_disk,
    const float* load_leader, const float* load_follower, cudaStream_t stream) {
  if (k <= 0) return 0;
  if ((topic && (!tbc || !lower_t || !upper_t)) ||
      (min_leaders && (!tlc || !designated || !is_leader || !alive)) ||
      (rack_dist && (!partition_rf || num_racks < 1)) ||
      (intra_cap && !up_cap) || (intra_dist && !up_dist) ||
      ((intra_cap || intra_dist) && (!disk_load || !src_disk || !dest_disk ||
                                     !load_leader || !load_follower || !is_leader)))
    return static_cast<int>(cudaErrorInvalidValue);
  AcceptArgs a;
  a.rack = static_cast<int>(rack);
  a.intra_cap = static_cast<int>(intra_cap);
  a.intra_dist = static_cast<int>(intra_dist);
  a.disk_load = disk_load;
  a.up_cap = up_cap;
  a.up_dist = up_dist;
  a.src_disk = src_disk;
  a.dest_disk = dest_disk;
  a.load_leader = load_leader;
  a.load_follower = load_follower;
  a.rack_dist = static_cast<int>(rack_dist);
  a.topic = static_cast<int>(topic);
  a.min_leaders = static_cast<int>(min_leaders);
  a.k = k;
  a.num_brokers = num_brokers;
  a.max_rf = max_rf;
  a.need = need;
  a.num_racks = num_racks;
  a.action_type = action_type;
  a.replica = replica;
  a.src = src;
  a.dest = dest;
  a.dest_replica = dest_replica;
  a.replica_topic = replica_topic;
  a.replica_partition = replica_partition;
  a.replica_broker = replica_broker;
  a.partition_replicas = partition_replicas;
  a.broker_rack = broker_rack;
  a.tbc = tbc;
  a.lower_t = lower_t;
  a.upper_t = upper_t;
  a.is_leader = is_leader;
  a.alive = alive;
  a.tlc = tlc;
  a.designated = designated;
  a.partition_rf = partition_rf;
  a.out = out;
  const unsigned blocks = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  structural_accepts_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_goal_masks(
    int64_t mode, int64_t delta_sel, int64_t k, int64_t num_brokers, int64_t max_rf,
    int64_t need, int64_t num_racks, float eps, const int32_t* action_type, const int32_t* replica, const int32_t* src,
    const int32_t* dest, const uint8_t* valid, const uint8_t* accepted,
    const float* delta_src, const float* delta_dest, const int32_t* d_replica_count,
    const int32_t* d_leader_count, const float* d_pnw, const float* d_lbi_src,
    const float* d_lbi_dest, const uint8_t* alive, const float* metric,
    const float* lower, const float* upper, const uint8_t* offline_now,
    const int32_t* replica_topic, const int32_t* replica_partition,
    const int32_t* replica_broker, const uint8_t* conflict, const int32_t* tbc,
    const float* lower_t, const float* upper_t, const float* avg_t,
    const int32_t* partition_replicas, const int32_t* broker_rack, float* score,
    uint8_t* eligible, const int32_t* dest_replica, const int8_t* broker_state,
    const uint8_t* is_leader, const uint8_t* replica_valid, const int32_t* tlc,
    const uint8_t* designated, const int32_t* partition_rf, const float* disk_load,
    const float* lo_d, const float* up_d, const float* disk_capacity,
    const int32_t* disk_broker, const int32_t* src_disk, const int32_t* dest_disk,
    const float* load_leader, const float* load_follower, cudaStream_t stream) {
  if (k <= 0) return 0;
  if (mode < kThreshold || mode > kIntraDisk || delta_sel < 0 || delta_sel > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kIntraDisk &&
      (!disk_load || !lo_d || !up_d || !disk_capacity || !disk_broker || !src_disk ||
       !dest_disk || !load_leader || !load_follower || !is_leader || !dest_replica))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool band = mode == kThreshold || mode == kDistribution;
  if ((band && (!metric || !lower || !upper)) ||
      (mode == kTopic && (!tbc || !lower_t || !upper_t || !avg_t)) ||
      ((mode == kRack || mode == kRackDist) && !conflict) ||
      (mode == kRackDist && (!partition_rf || num_racks < 1)) ||
      (mode == kMinLeaders && (!tlc || !designated)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.mode = static_cast<int>(mode);
  a.delta_sel = static_cast<int>(delta_sel);
  a.k = k;
  a.num_brokers = num_brokers;
  a.max_rf = max_rf;
  a.need = need;
  a.num_racks = num_racks;
  a.eps = eps;
  a.action_type = action_type;
  a.replica = replica;
  a.src = src;
  a.dest = dest;
  a.valid = valid;
  a.accepted = accepted;
  a.delta_src = delta_src;
  a.delta_dest = delta_dest;
  a.d_replica_count = d_replica_count;
  a.d_leader_count = d_leader_count;
  a.d_pnw = d_pnw;
  a.d_lbi_src = d_lbi_src;
  a.d_lbi_dest = d_lbi_dest;
  a.alive = alive;
  a.metric = metric;
  a.lower = lower;
  a.upper = upper;
  a.offline_now = offline_now;
  a.replica_topic = replica_topic;
  a.replica_partition = replica_partition;
  a.replica_broker = replica_broker;
  a.conflict = conflict;
  a.tbc = tbc;
  a.lower_t = lower_t;
  a.upper_t = upper_t;
  a.avg_t = avg_t;
  a.partition_replicas = partition_replicas;
  a.broker_rack = broker_rack;
  a.score = score;
  a.eligible = eligible;
  a.dest_replica = dest_replica;
  a.broker_state = broker_state;
  a.is_leader = is_leader;
  a.replica_valid = replica_valid;
  a.tlc = tlc;
  a.designated = designated;
  a.partition_rf = partition_rf;
  a.disk_load = disk_load;
  a.lo_d = lo_d;
  a.up_d = up_d;
  a.disk_capacity = disk_capacity;
  a.disk_broker = disk_broker;
  a.src_disk = src_disk;
  a.dest_disk = dest_disk;
  a.load_leader = load_leader;
  a.load_follower = load_follower;
  const unsigned blocks = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  goal_masks_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
