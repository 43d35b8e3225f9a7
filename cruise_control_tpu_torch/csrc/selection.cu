// K4 — the selection glue of select_batched: four kernels.
//
// Replace the elementwise and scatter passes between K2's and K3's launches
// in every round of cruise_control_tpu/analyzer/optimizer.py:410-871
// select_batched (the wrappers and plain twins: ops/selection.py):
//
//   cc_select_mask       (K4a, :584-587, 599-637)  a round's eligibility;
//   cc_topic_round_sums  (K4b, :671-682, 745-749, 859-860)  the kept legs'
//                        (topic, broker) sums, their budget test and its
//                        fold onto the brokers;
//   cc_net_viol          (K4c, :739-751)  the brokers out of their channel
//                        budgets after a round's sums;
//   cc_partition_claims  (K4d, :645-652, 851-864)  kept lanes OR-scattered
//                        onto their partitions (and disks).
//
// Exactness: every output is a bool or an integer-valued float, and the
// card equals the plain twin bit for bit.  Budget tests add a cumulative sum
// and a delta with __fadd_rn, form `bound + eps` and `-bound - eps` with
// __fadd_rn / __fsub_rn and compare in f32, as torch does (no contraction:
// nothing here is a product).  K4b's deltas are -1, 0 or +1: a key's sum is
// an integer of at most K * L in size, so it is summed in int32 atomics,
// exact in any order, and converted to f32 once; the JAX package's float
// scatter-add of the same integers is exact too, so the two are equal.  No
// float atomic anywhere, and an unkept lane's legs are never visited.
//
// Bound on the card: bytes in all four (a lane's 72 bytes of deltas and a
// few indices; a key's budgets), and at the main path's shapes (K <= 65,536
// lanes, n_tb = 20,000 keys, nb <= 200 brokers) each launch moves well under
// 10 MB, so each is launch-bound: one thread a lane, a key or a broker, no
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
