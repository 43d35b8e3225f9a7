// K4 — the selection glue of select_batched: six kernels.
//
// Replace the elementwise, gather and scatter passes of
// cruise_control_tpu/analyzer/optimizer.py:410-871 select_batched around
// K2's and K3's launches (the wrappers and plain twins: ops/selection.py):
//
//   cc_select_legs       (K4e, :514-580)  once a step, after the live-lane
//                        compaction: the compacted lanes' fields, broker
//                        slots, subround keys, channel deltas and (topic,
//                        broker) legs, in the layouts the rounds read;
//   cc_frontier_budgets  (K4e, :521-531)  the broker and (topic, broker)
//                        budgets gathered onto the frontier's slots, with
//                        K3's bounds of the topic cuts;
//   cc_select_mask       (K4a, :584-587, 599-637)  a round's eligibility;
//   cc_topic_round_sums  (K4b, :671-682, 745-749, 859-860)  the kept legs'
//                        (topic, broker) sums, their budget test and its
//                        fold onto the brokers;
//   cc_net_viol          (K4c, :739-751)  the brokers out of their channel
//                        budgets after a round's sums;
//   cc_partition_claims  (K4d, :645-652, 851-864)  kept lanes OR-scattered
//                        onto their partitions (and disks).
//
// Exactness: every output is a bool, an integer, a gathered float or its
// sign flip (negation, never `0 - x`: -0.0 stays -0.0), or an
// integer-valued float, and the card equals the plain twin bit for bit.
// Budget tests add a cumulative sum and a delta with __fadd_rn, form
// `bound + eps` and `-bound - eps` with __fadd_rn / __fsub_rn and compare in
// f32, as torch does (no contraction: nothing here is a product).  K4b's
// deltas are -1, 0 or +1: a key's sum is an integer of at most K * L in
// size, so it is summed in int32 atomics, exact in any order, and converted
// to f32 once; the JAX package's float scatter-add of the same integers is
// exact too, so the two are equal.  No float atomic anywhere, and an unkept
// lane's legs are never visited.
//
// Bound on the card: bytes in all six (a lane's 72 bytes of deltas and a
// few indices; a key's budgets; K4e's gathers and its writes of the legs),
// and at the main path's shapes (K <= 65,536 lanes, n_tb = 20,000 keys,
// nb <= 200 brokers) each launch moves well under 10 MB, so each is
// launch-bound: one thread a lane, a key or a broker, no
// shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 8;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float hi_of(float bound) { return __fadd_rn(bound, kEps); }
__device__ __forceinline__ float lo_of(float bound) { return __fsub_rn(-bound, kEps); }

__device__ __forceinline__ bool in_range(int64_t i, int64_t n) { return i >= 0 && i < n; }

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// ---------------------------------------------------------------------------
// K4a: one thread a lane; it stops at its first failed test.
// ---------------------------------------------------------------------------
__global__ void select_mask_kernel(
    int64_t k, int64_t nb, int64_t legs, int64_t n_tb, int64_t num_parts, int64_t num_disks,
    const uint8_t* __restrict__ eligible, const float* __restrict__ d_src,
    const float* __restrict__ d_dest, const int32_t* __restrict__ src_b,
    const int32_t* __restrict__ dest_b, const float* __restrict__ room_dest,
    const float* __restrict__ slack_src, const float* __restrict__ cum_net,
    const int32_t* __restrict__ leg_keys, const float* __restrict__ d_rep,
    const float* __restrict__ d_lead, const float* __restrict__ gain_rep,
    const float* __restrict__ shed_rep, const float* __restrict__ shed_lead,
    const float* __restrict__ cum_rep, const float* __restrict__ cum_lead,
    const uint8_t* __restrict__ keep_total, const uint8_t* __restrict__ used_part,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ partition2,
    const int32_t* __restrict__ src_disk, const int32_t* __restrict__ dest_disk,
    const uint8_t* __restrict__ used_sdisk, const uint8_t* __restrict__ used_ddisk,
    uint8_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k) return;
  bool ok = eligible[i] != 0;
  if (ok && used_part != nullptr) {
    const int32_t p = partition[i], p2 = partition2[i];
    ok = keep_total[i] == 0 && in_range(p, num_parts) && in_range(p2, num_parts) &&
         used_part[p] == 0 && used_part[p2] == 0;
  }
  if (ok && used_sdisk != nullptr && dest_disk[i] >= 0) {
    const int32_t sd = max(src_disk[i], 0), dd = dest_disk[i];
    ok = in_range(sd, num_disks) && in_range(dd, num_disks) && used_sdisk[sd] == 0 &&
         used_ddisk[dd] == 0;
  }
  if (ok) {
    const int32_t bd = dest_b[i], bs = src_b[i];
    ok = in_range(bd, nb) && in_range(bs, nb);
    const float* dd_row = d_dest + i * kChannels;
    const float* ds_row = d_src + i * kChannels;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      if (!ok) break;
      float td = dd_row[c], ts = ds_row[c];
      if (cum_net != nullptr) {
        td = __fadd_rn(cum_net[bd * kChannels + c], td);
        ts = __fadd_rn(cum_net[bs * kChannels + c], ts);
      }
      ok = td <= hi_of(room_dest[bd * kChannels + c]) &&
           td >= lo_of(slack_src[bd * kChannels + c]) &&
           ts >= lo_of(slack_src[bs * kChannels + c]) &&
           ts <= hi_of(room_dest[bs * kChannels + c]);
    }
  }
  if (ok && gain_rep != nullptr) {
    for (int64_t l = 0; l < legs && ok; ++l) {
      const int64_t at = l * k + i;
      const int32_t key = leg_keys[at];
      if (!in_range(key, n_tb)) {
        ok = false;
        break;
      }
      float rep = d_rep[at], lead = d_lead[at];
      if (cum_rep != nullptr) {
        rep = __fadd_rn(cum_rep[key], rep);
        lead = __fadd_rn(cum_lead[key], lead);
      }
      // The leader legs have no gain budget (+inf): only NaN fails it.
      ok = rep <= hi_of(gain_rep[key]) && rep >= lo_of(shed_rep[key]) &&
           lead <= INFINITY && lead >= lo_of(shed_lead[key]);
    }
  }
  out[i] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K4b: the kept legs' deltas into int32 counts [rep | lead], then a thread a
// key for the cum, the budgets and the fold.
// ---------------------------------------------------------------------------
__global__ void topic_count_kernel(int64_t k, int64_t legs, int64_t n_tb,
                                   const uint8_t* __restrict__ keep,
                                   const int32_t* __restrict__ leg_keys,
                                   const float* __restrict__ d_rep,
                                   const float* __restrict__ d_lead,
                                   int32_t* __restrict__ counts) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= legs * k || !keep[t % k]) return;
  const int32_t key = leg_keys[t];
  if (!in_range(key, n_tb)) return;
  const float r = d_rep[t], l = d_lead[t];
  if (r != 0.0f) atomicAdd(counts + key, __float2int_rn(r));
  if (l != 0.0f) atomicAdd(counts + n_tb + key, __float2int_rn(l));
}

__global__ void topic_viol_kernel(int64_t n_tb, int64_t nb_sel,
                                  const int32_t* __restrict__ counts,
                                  const float* __restrict__ gain_rep,
                                  const float* __restrict__ shed_rep,
                                  const float* __restrict__ shed_lead,
                                  const float* __restrict__ cum_rep,
                                  const float* __restrict__ cum_lead,
                                  uint8_t* __restrict__ vt, uint8_t* __restrict__ bad_b,
                                  float* __restrict__ rep_out, float* __restrict__ lead_out) {
  const int64_t key = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (key >= n_tb) return;
  float rep = __int2float_rn(counts[key]);
  float lead = __int2float_rn(counts[n_tb + key]);
  if (cum_rep != nullptr) {
    rep = __fadd_rn(cum_rep[key], rep);
    lead = __fadd_rn(cum_lead[key], lead);
  }
  const bool v = rep > hi_of(gain_rep[key]) || rep < lo_of(shed_rep[key]) ||
                 lead < lo_of(shed_lead[key]);
  vt[key] = v ? 1 : 0;
  if (v) bad_b[key % nb_sel] = 1;  // every writer stores the same byte
  if (rep_out != nullptr) {
    rep_out[key] = rep;
    lead_out[key] = lead;
  }
}

// ---------------------------------------------------------------------------
// K4c: one thread a broker.
// ---------------------------------------------------------------------------
__global__ void net_viol_kernel(int64_t nb, const float* __restrict__ cum_net,
                                const float* __restrict__ round_net,
                                const float* __restrict__ room_dest,
                                const float* __restrict__ slack_src,
                                const uint8_t* __restrict__ bad_b, uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (b >= nb) return;
  bool v = bad_b != nullptr && bad_b[b] != 0;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const int64_t at = b * kChannels + c;
    const float total = cum_net != nullptr ? __fadd_rn(cum_net[at], round_net[at])
                                           : round_net[at];
    v = v || total > hi_of(room_dest[at]) || total < lo_of(slack_src[at]);
  }
  out[b] = v ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K4d: kept lanes store a 1 at each of their claims; a claim round then
// drops the lanes whose second partition another lane claimed.
// ---------------------------------------------------------------------------
__global__ void claim_scatter_kernel(int64_t k, int64_t num_parts, int64_t num_disks,
                                     const uint8_t* __restrict__ keep,
                                     const int32_t* __restrict__ partition,
                                     const int32_t* __restrict__ partition2,
                                     uint8_t* __restrict__ claims, bool both,
                                     const int32_t* __restrict__ src_disk,
                                     const int32_t* __restrict__ dest_disk,
                                     uint8_t* __restrict__ used_sdisk,
                                     uint8_t* __restrict__ used_ddisk) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k || !keep[i]) return;
  const int32_t p = partition[i];
  if (in_range(p, num_parts)) claims[p] = 1;
  if (both) {
    const int32_t p2 = partition2[i];
    if (in_range(p2, num_parts)) claims[p2] = 1;
  }
  if (used_sdisk != nullptr && dest_disk[i] >= 0) {
    const int32_t sd = max(src_disk[i], 0), dd = dest_disk[i];
    if (in_range(sd, num_disks)) used_sdisk[sd] = 1;
    if (in_range(dd, num_disks)) used_ddisk[dd] = 1;
  }
}

__global__ void claim_drop_kernel(int64_t k, int64_t num_parts,
                                  const uint8_t* __restrict__ keep,
                                  const int32_t* __restrict__ partition,
                                  const int32_t* __restrict__ partition2,
                                  const uint8_t* __restrict__ claims,
                                  uint8_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k) return;
  bool kept = keep[i] != 0;
  if (kept) {
    const int32_t p = partition[i], p2 = partition2[i];
    kept = !(p2 != p && in_range(p2, num_parts) && claims[p2] != 0);
  }
  out[i] = kept ? 1 : 0;
}


// ---------------------------------------------------------------------------
// K4e: the leg build and the compaction gathers, one thread a compacted lane
// (through sel_idx, or the identity when nothing is compacted).  Layouts:
// score_out holds max(2, legs) copies of the lanes' scores (K3's safe
// admits read 2 or `legs` of them back to back); seg3 is [dest_b; src_b;
// dest_b] and d3 the same rows of channel deltas (f32[3 kc, 8]), so that
// the round sums read [dest; src] and the safe admit [src; dest] as views;
// the legs are [legs, kc] (d_rl: [legs, kc, 2], K3's (rep, lead) columns).
// ---------------------------------------------------------------------------
// analyzer/actions.py ActionType
constexpr int32_t kMove = 0, kLeadership = 1, kSwap = 3;
constexpr int32_t kLegLanes = 16;  // K2's subround lanes of a (topic, broker) key

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);  // the JAX package's gather
}

__global__ void select_legs_kernel(
    int64_t kc, int64_t k_full, int64_t nb_sel, int64_t subrounds, int64_t legs,
    int64_t num_brokers, int64_t num_replicas, const int32_t* __restrict__ sel_idx,
    const float* __restrict__ score, const uint8_t* __restrict__ eligible,
    const int32_t* __restrict__ lane, const int32_t* __restrict__ action_type,
    const int32_t* __restrict__ replica, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dest, const int32_t* __restrict__ dest_replica,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ partition2,
    const int32_t* __restrict__ src_disk, const int32_t* __restrict__ dest_disk,
    const float* __restrict__ delta_src, const float* __restrict__ delta_dest,
    const int32_t* __restrict__ d_replica_count, const int32_t* __restrict__ d_leader_count,
    const float* __restrict__ d_pnw, const float* __restrict__ d_lbi_src,
    const float* __restrict__ d_lbi_dest, const int32_t* __restrict__ compact_of_full,
    const int32_t* __restrict__ replica_topic, const uint8_t* __restrict__ replica_is_leader,
    float* __restrict__ score_out, uint8_t* __restrict__ elig_out,
    int32_t* __restrict__ part_out, int32_t* __restrict__ part2_out,
    int32_t* __restrict__ sdisk_out, int32_t* __restrict__ ddisk_out,
    int32_t* __restrict__ seg3, int32_t* __restrict__ src_lane_out,
    int32_t* __restrict__ dest_lane_out, float* __restrict__ d3,
    int32_t* __restrict__ leg_keys, float* __restrict__ d_rep, float* __restrict__ d_lead,
    float* __restrict__ d_rl, uint8_t* __restrict__ leg_nz,
    int32_t* __restrict__ leg_lane_keys) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (j >= kc) return;
  const int64_t i = sel_idx != nullptr ? clamp_index(sel_idx[j], k_full) : j;
  const float sc = score[i];
  const int64_t copies = legs > 2 ? legs : 2;
  for (int64_t c = 0; c < copies; ++c) score_out[c * kc + j] = sc;
  elig_out[j] = eligible[i];
  part_out[j] = partition[i];
  part2_out[j] = partition2[i];
  sdisk_out[j] = src_disk[i];
  ddisk_out[j] = dest_disk[i];
  int32_t sb = src[i], db = dest[i];
  if (compact_of_full != nullptr) {
    sb = max(compact_of_full[clamp_index(sb, num_brokers)], 0);
    db = max(compact_of_full[clamp_index(db, num_brokers)], 0);
  }
  seg3[j] = db;
  seg3[kc + j] = sb;
  seg3[2 * kc + j] = db;
  const int32_t ln = lane[i];
  src_lane_out[j] = sb * static_cast<int32_t>(subrounds) + ln;
  dest_lane_out[j] = db * static_cast<int32_t>(subrounds) + ln;
  float dd[kChannels], ds[kChannels];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    dd[r] = delta_dest[i * 4 + r];
    ds[r] = delta_src[i * 4 + r];
  }
  const float dc = static_cast<float>(d_replica_count[i]);
  const float dl = static_cast<float>(d_leader_count[i]);
  const float dp = d_pnw[i];
  dd[4] = dc;
  dd[5] = dl;
  dd[6] = dp;
  dd[7] = d_lbi_dest[i];
  ds[4] = -dc;
  ds[5] = -dl;
  ds[6] = -dp;
  ds[7] = -d_lbi_src[i];
#pragma unroll
  for (int r = 0; r < kChannels; ++r) {
    d3[j * kChannels + r] = dd[r];
    d3[(kc + j) * kChannels + r] = ds[r];
    d3[(2 * kc + j) * kChannels + r] = dd[r];
  }
  if (legs == 0) return;
  const int32_t at = action_type[i];
  const bool moves_tb = at == kMove || at == kSwap, swap = at == kSwap;
  const int64_t r1 = clamp_index(replica[i], num_replicas);
  const int32_t t1 = replica_topic[r1];
  const int32_t nb = static_cast<int32_t>(nb_sel);
  const float lead1 = (at == kLeadership || (moves_tb && replica_is_leader[r1] != 0)) ? 1.0f
                                                                                       : 0.0f;
  int32_t key[4];
  float rep[4], ld[4];
  key[0] = t1 * nb + sb;
  key[1] = t1 * nb + db;
  if (legs == 4) {
    const int32_t dr = dest_replica[i];
    const int64_t r2 = clamp_index(dr >= 0 ? dr : 0, num_replicas);
    const int32_t t2 = replica_topic[r2];
    const bool same_t = swap && t1 == t2;
    const float rep1 = same_t ? 0.0f : (moves_tb ? 1.0f : 0.0f);
    const float rep2 = same_t ? 0.0f : (swap ? 1.0f : 0.0f);
    const float lead2 = (swap && replica_is_leader[r2] != 0) ? 1.0f : 0.0f;
    const float l1 = same_t ? __fsub_rn(lead1, lead2) : lead1;
    const float l2 = same_t ? 0.0f : lead2;
    key[2] = t2 * nb + db;
    key[3] = t2 * nb + sb;
    rep[0] = -rep1;
    rep[1] = rep1;
    rep[2] = -rep2;
    rep[3] = rep2;
    ld[0] = -l1;
    ld[1] = l1;
    ld[2] = -l2;
    ld[3] = l2;
  } else {
    const float mv = moves_tb ? 1.0f : 0.0f;
    rep[0] = -mv;
    rep[1] = mv;
    ld[0] = -lead1;
    ld[1] = lead1;
  }
  const int32_t lane_tb = ln % kLegLanes;
  for (int64_t l = 0; l < legs; ++l) {
    const int64_t o = l * kc + j;
    leg_keys[o] = key[l];
    d_rep[o] = rep[l];
    d_lead[o] = ld[l];
    d_rl[2 * o] = rep[l];
    d_rl[2 * o + 1] = ld[l];
    leg_nz[o] = (rep[l] != 0.0f || ld[l] != 0.0f) ? 1 : 0;
    leg_lane_keys[o] = key[l] * kLegLanes + lane_tb;
  }
}

// K4e's budgets: one thread a (slot, channel) of the broker budgets and a
// (topic, slot) key of the topic budgets.
__global__ void frontier_budgets_kernel(
    int64_t nb_sel, int64_t num_brokers, int64_t num_topics, const float* __restrict__ room,
    const float* __restrict__ slack, const int32_t* __restrict__ full_of_compact,
    const float* __restrict__ gain_rep, const float* __restrict__ shed_rep,
    const float* __restrict__ shed_lead, float* __restrict__ room_out,
    float* __restrict__ slack_out, float* __restrict__ neg_slack_out,
    float* __restrict__ gain_out, float* __restrict__ shed_out, float* __restrict__ lead_out,
    float* __restrict__ hi_tb, float* __restrict__ lo_tb) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  auto gather = [&](int64_t c) -> int64_t {
    return full_of_compact != nullptr
               ? clamp_index(max(full_of_compact[c], 0), num_brokers) : c;
  };
  if (t < nb_sel * kChannels) {
    const int64_t at = gather(t / kChannels) * kChannels + t % kChannels;
    const float s = slack[at];
    room_out[t] = room[at];
    slack_out[t] = s;
    neg_slack_out[t] = -s;
  }
  if (gain_rep != nullptr && t < num_topics * nb_sel) {
    const int64_t at = (t / nb_sel) * num_brokers + gather(t % nb_sel);
    const float g = gain_rep[at], s = shed_rep[at], l = shed_lead[at];
    gain_out[t] = g;
    shed_out[t] = s;
    lead_out[t] = l;
    hi_tb[2 * t] = g;
    hi_tb[2 * t + 1] = INFINITY;
    lo_tb[2 * t] = -s;
    lo_tb[2 * t + 1] = -l;
  }
}

}  // namespace

// A null cum_net: round 1.  A null gain_rep: no topic budgets (the other
// topic pointers are then unread); a null cum_rep: round 1.  A null
// used_part: round 1 (keep_total, partition and partition2 unread); a null
// used_sdisk: no disk guard or round 1.
extern "C" int cc_select_mask(
    int64_t k, int64_t nb, int64_t legs, int64_t n_tb, int64_t num_parts, int64_t num_disks,
    const uint8_t* eligible, const float* d_src, const float* d_dest, const int32_t* src_b,
    const int32_t* dest_b, const float* room_dest, const float* slack_src,
    const float* cum_net, const int32_t* leg_keys, const float* d_rep, const float* d_lead,
    const float* gain_rep, const float* shed_rep, const float* shed_lead,
    const float* cum_rep, const float* cum_lead, const uint8_t* keep_total,
    const uint8_t* used_part, const int32_t* partition, const int32_t* partition2,
    const int32_t* src_disk, const int32_t* dest_disk, const uint8_t* used_sdisk,
    const uint8_t* used_ddisk, uint8_t* out, cudaStream_t stream) {
  if (k <= 0) return 0;
  if ((gain_rep != nullptr) && (legs <= 0 || n_tb <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  select_mask_kernel<<<blocks_for(k), kThreads, 0, stream>>>(
      k, nb, legs, n_tb, num_parts, num_disks, eligible, d_src, d_dest, src_b, dest_b,
      room_dest, slack_src, cum_net, leg_keys, d_rep, d_lead, gain_rep, shed_rep, shed_lead,
      cum_rep, cum_lead, keep_total, used_part, partition, partition2, src_disk, dest_disk,
      used_sdisk, used_ddisk, out);
  return static_cast<int>(cudaGetLastError());
}

// counts: i32[2 * n_tb] scratch; rep_out and lead_out null unless the
// caller wants the next round's cumulative sums.
extern "C" int cc_topic_round_sums(
    int64_t k, int64_t legs, int64_t n_tb, int64_t nb_sel, const uint8_t* keep,
    const int32_t* leg_keys, const float* d_rep, const float* d_lead, const float* gain_rep,
    const float* shed_rep, const float* shed_lead, const float* cum_rep,
    const float* cum_lead, int32_t* counts, uint8_t* vt, uint8_t* bad_b, float* rep_out,
    float* lead_out, cudaStream_t stream) {
  if (n_tb <= 0 || nb_sel <= 0 || n_tb % nb_sel != 0 || k < 0 || legs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(counts, 0, sizeof(int32_t) * 2 * n_tb, stream);
  cudaMemsetAsync(bad_b, 0, nb_sel, stream);
  if (legs * k > 0)
    topic_count_kernel<<<blocks_for(legs * k), kThreads, 0, stream>>>(
        k, legs, n_tb, keep, leg_keys, d_rep, d_lead, counts);
  topic_viol_kernel<<<blocks_for(n_tb), kThreads, 0, stream>>>(
      n_tb, nb_sel, counts, gain_rep, shed_rep, shed_lead, cum_rep, cum_lead, vt, bad_b,
      rep_out, lead_out);
  return static_cast<int>(cudaGetLastError());
}

// cum_net and bad_b may be null (round 1; no topic budgets).
extern "C" int cc_net_viol(int64_t nb, const float* cum_net, const float* round_net,
                           const float* room_dest, const float* slack_src,
                           const uint8_t* bad_b, uint8_t* out, cudaStream_t stream) {
  if (nb <= 0) return 0;
  net_viol_kernel<<<blocks_for(nb), kThreads, 0, stream>>>(nb, cum_net, round_net, room_dest,
                                                           slack_src, bad_b, out);
  return static_cast<int>(cudaGetLastError());
}

// With out non-null, a claim round: claims (u8[num_parts] scratch) is zeroed,
// filled from `partition` alone and read back into out = keep minus the
// claimed lanes.  With out null, claims is the step's used partitions,
// updated in place from `partition` and `partition2`, and the disks with it
// when used_sdisk is non-null.
extern "C" int cc_partition_claims(int64_t k, int64_t num_parts, int64_t num_disks,
                                   const uint8_t* keep, const int32_t* partition,
                                   const int32_t* partition2, uint8_t* claims, uint8_t* out,
                                   const int32_t* src_disk, const int32_t* dest_disk,
                                   uint8_t* used_sdisk, uint8_t* used_ddisk,
                                   cudaStream_t stream) {
  if (k <= 0 || num_parts <= 0) return 0;
  const bool claim_round = out != nullptr;
  if (claim_round && used_sdisk != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (claim_round) cudaMemsetAsync(claims, 0, num_parts, stream);
  claim_scatter_kernel<<<blocks_for(k), kThreads, 0, stream>>>(
      k, num_parts, num_disks, keep, partition, partition2, claims, !claim_round, src_disk,
      dest_disk, used_sdisk, used_ddisk);
  if (claim_round)
    claim_drop_kernel<<<blocks_for(k), kThreads, 0, stream>>>(k, num_parts, keep, partition,
                                                              partition2, claims, out);
  return static_cast<int>(cudaGetLastError());
}

// K4e.  sel_idx null: no compaction (kc == k_full).  compact_of_full null:
// no frontier (the broker ids are the slots; num_brokers unread).  legs 0: no (topic, broker)
// budgets (replica_topic, replica_is_leader and the leg outputs unread);
// else 2 or 4 (swaps).
extern "C" int cc_select_legs(
    int64_t kc, int64_t k_full, int64_t nb_sel, int64_t subrounds, int64_t legs,
    int64_t num_brokers, int64_t num_replicas, const int32_t* sel_idx, const float* score,
    const uint8_t* eligible, const int32_t* lane, const int32_t* action_type,
    const int32_t* replica, const int32_t* src, const int32_t* dest,
    const int32_t* dest_replica, const int32_t* partition, const int32_t* partition2,
    const int32_t* src_disk, const int32_t* dest_disk, const float* delta_src,
    const float* delta_dest, const int32_t* d_replica_count, const int32_t* d_leader_count,
    const float* d_pnw, const float* d_lbi_src, const float* d_lbi_dest,
    const int32_t* compact_of_full, const int32_t* replica_topic,
    const uint8_t* replica_is_leader, float* score_out, uint8_t* elig_out, int32_t* part_out,
    int32_t* part2_out, int32_t* sdisk_out, int32_t* ddisk_out, int32_t* seg3,
    int32_t* src_lane_out, int32_t* dest_lane_out, float* d3, int32_t* leg_keys, float* d_rep,
    float* d_lead, float* d_rl, uint8_t* leg_nz, int32_t* leg_lane_keys, cudaStream_t stream) {
  if (kc <= 0) return 0;
  if ((legs != 0 && legs != 2 && legs != 4) || k_full <= 0 ||
      (compact_of_full != nullptr && num_brokers <= 0) ||
      (sel_idx == nullptr && kc != k_full) || (legs != 0 && num_replicas <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  select_legs_kernel<<<blocks_for(kc), kThreads, 0, stream>>>(
      kc, k_full, nb_sel, subrounds, legs, num_brokers, num_replicas, sel_idx, score, eligible,
      lane, action_type, replica, src, dest, dest_replica, partition, partition2, src_disk,
      dest_disk, delta_src, delta_dest, d_replica_count, d_leader_count, d_pnw, d_lbi_src,
      d_lbi_dest, compact_of_full, replica_topic, replica_is_leader, score_out, elig_out,
      part_out, part2_out, sdisk_out, ddisk_out, seg3, src_lane_out, dest_lane_out, d3,
      leg_keys, d_rep, d_lead, d_rl, leg_nz, leg_lane_keys);
  return static_cast<int>(cudaGetLastError());
}

// K4e's budgets.  full_of_compact null: no frontier (nb_sel == num_brokers).
// gain_rep null: no topic budgets (the topic outputs unwritten).
extern "C" int cc_frontier_budgets(int64_t nb_sel, int64_t num_brokers, int64_t num_topics,
                                   const float* room, const float* slack,
                                   const int32_t* full_of_compact, const float* gain_rep,
                                   const float* shed_rep, const float* shed_lead,
                                   float* room_out, float* slack_out, float* neg_slack_out,
                                   float* gain_out, float* shed_out, float* lead_out,
                                   float* hi_tb, float* lo_tb, cudaStream_t stream) {
  if (nb_sel <= 0 || num_brokers <= 0 ||
      (full_of_compact == nullptr && nb_sel != num_brokers))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tb = gain_rep != nullptr ? num_topics * nb_sel : 0;
  const int64_t n = nb_sel * kChannels > n_tb ? nb_sel * kChannels : n_tb;
  frontier_budgets_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      nb_sel, num_brokers, num_topics, room, slack, full_of_compact, gain_rep, shed_rep,
      shed_lead, room_out, slack_out, neg_slack_out, gain_out, shed_out, lead_out, hi_tb,
      lo_tb);
  return static_cast<int>(cudaGetLastError());
}
