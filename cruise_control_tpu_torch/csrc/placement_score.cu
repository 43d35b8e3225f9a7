// K10 — the balancedness of execution checkpoints: every goal's satisfied
// flag for a batch of C blends of two placements, in two launches (three
// with the intra-broker disk goals).
//
// Replaces cruise_control_tpu/analyzer/optimizer.py:2392
// _get_placement_score_fn (called by PlacementScorer.score, :2474): for each
// landed-partition mask m[c, P], the replicas of landed partitions take the
// after model's broker, disk and leader flag and every other replica the
// before model's, then _stack_satisfied (:2331) runs on the blend —
// BrokerArrays.from_model (and disk_load) and goal_satisfied for each of the
// G goals.  The result is bool[C, G]; the offline flag is dropped there, so
// it is not computed here.  No copy of the model is built: every kernel
// reads the blend through the mask.  A partition index is clamped into
// [0, P) before it indexes a mask, as the JAX package's gather clamps.
//
// cc_blend_aggregates: each blend's per-broker sums and counts.  The
// wrapper hands it a per-broker row index built per call
// (kernels.blend_row_index: this file's index_keys_kernel, cc_argsort of
// argsort.cu and index_offsets_kernel; a CSR of offsets i32[B + 1] and
// rows): the rows
// of broker s are every valid row whose before-broker is s and every valid
// row whose after-broker is s and differs from its before-broker, in
// increasing row order.  Whatever the mask, a valid row that blend c puts
// on s is one of s's index rows.  Grid (ceil(B / 8), ceil(C / 32 L)):
// each warp owns one broker s and 32 L consecutive blends, L of them a
// lane (L in 1, 2, 4, 8: the largest that still gives 4,096 warps, so
// wide grids stage each row fewer times and narrow ones keep more warps in
// flight; 1,024 for the disk loads), and a block holds 8 neighbouring
// brokers.  The warp takes s's
// rows 32 at a time: each lane loads one row (partition, both brokers,
// both leader flags, both load rows) into registers a chunk ahead and
// stores it in shared memory; then each lane reads the landed flags of its
// blends for the 32 staged rows at once from the masks transposed to
// [P, C'] (C' = C rounded up to 8; one aligned L-byte load a row, the
// warp's on consecutive bytes) and walks the rows in order, keeping for
// each of its blends the rows the blend puts on s and adding their six
// floats with __fadd_rn into registers.  Each (c, s) sum thus starts at 0
// and adds exactly the rows the plain version's index_add_ adds, in
// increasing row order: the CPU's bits, and an all-false mask gives K1's.
// Replica and leader counts are kept in registers.  The (c, topic, b)
// replica and leader counts come from a second kernel of the same entry
// that walks a per-topic row index (the valid rows of each topic): block
// (t, blend group, broker tile) counts its topic's rows into histograms in
// shared memory with integer atomics (exact in any order) and writes every
// cell of its tile, each (c, t) row's brokers on consecutive addresses, so
// the [C, T, B] tables are written once and need no zeroing.  The wrapper hands the masks
// transposed (masks_by_partition_kernel, 32 x 32 tiles).
//
// cc_blend_disk_load: each blend's disk loads for the intra-broker disk
// goals, the same walk over a per-disk row index (before and after disks):
// grid (ceil(D / 8), ceil(C / 32 L)), one DISK sum per (c, d) in row
// order, every one written.
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
// Work of the two blend kernels: C x (R + moved rows) row visits, where a
// moved row is one whose broker (disk) differs between the placements, and
// C x R more for the topic counts; the former design, one block per
// (broker, blend) walking the whole replica axis, made B x C x R.
//
// Bound on the card: bytes.  The aggregates must read the C x P masks, the
// two placements (broker ids and leader flags), the replica partitions,
// valid flags, topics and load rows once, and write C x B x 32 bytes of
// aggregates and the C x T x B topic (and topic leader) counts; the disk
// loads read the masks, both placements' disks and leader flags and the
// DISK columns, and write C x D floats; the sweep writes C x G flags.  What
// still keeps the blend kernels from that bound: a segment's rows are
// added in order by one lane per blend (the order is what gives the CPU's
// bits), so a long segment is a long serial chain; each warp stages its
// rows from scattered addresses (an L2 gather, again for every group of
// 32 L blends, and for the topic counts again for every blend group of a
// topic); the masks are transposed and the indexes built by sorts each
// call.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Segments a block of the blend kernels walks, one a warp.  A lane owns L
// consecutive blends (L in 1, 2, 4, 8), so a warp owns one segment and 32 L
// blends: the largest L that still gives the card a kernel's busy count of
// warps (else 1), since a lane's L blends share one staging of each row
// but are walked in turn.  The aggregates add six floats a kept row and
// blend, the disk loads one, so staging weighs more in the disk walk and
// it settles for fewer warps.
constexpr int kWarps = 8;
constexpr int64_t kBusyWarpsAggregates = 4096, kBusyWarpsDisks = 1024;

__device__ __forceinline__ int32_t clamp_partition(int32_t q, int64_t p) {
  return q < 0 ? 0 : (q >= p ? static_cast<int32_t>(p - 1) : q);
}

// What both blend kernels read of a row: its clamped partition, its two
// segments (brokers or disks) and its two leader flags (bit 0 before, bit
// 1 after).
struct RowKey {
  int32_t q = 0, before = 0, after = 0;
  uint32_t lead = 0;
  __device__ __forceinline__ void load(int64_t r, const int32_t* __restrict__ partition,
                                       int64_t p, const int32_t* __restrict__ seg_before,
                                       const int32_t* __restrict__ seg_after,
                                       const uint8_t* __restrict__ before_lead,
                                       const uint8_t* __restrict__ after_lead) {
    q = clamp_partition(partition[r], p);
    before = seg_before[r];
    after = seg_after[r];
    lead = (before_lead[r] != 0 ? 1u : 0u) | (after_lead[r] != 0 ? 2u : 0u);
  }
};

// L bytes of the masks as one aligned load.
template <int L> struct MaskWord;
template <> struct MaskWord<1> { using type = uint8_t; };
template <> struct MaskWord<2> { using type = uint16_t; };
template <> struct MaskWord<4> { using type = uint32_t; };
template <> struct MaskWord<8> { using type = unsigned long long; };

// The landed flags of a lane's L blends (from ``first``) for the m (<= 32)
// staged rows whose clamped partitions are s_q, into s_landed[k] (bit j:
// blend first + j lands row k).  masks_t is [P, cp], cp a multiple of 8
// and zero past the last blend, so each row's flags are one aligned L-byte
// load, the warp's on 32 L consecutive bytes.  The loads of 16 rows are
// issued before any of them is used, so they are in flight together.
template <int L>
__device__ __forceinline__ void stage_landed(const uint8_t* __restrict__ masks_t, int64_t cp,
                                             int64_t first, bool owns, const int32_t* s_q,
                                             int m, uint8_t (*s_landed)[32], int lane) {
  using Word = typename MaskWord<L>::type;
#pragma unroll
  for (int h = 0; h < 32; h += 16) {
    Word x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      x[k] = owns && h + k < m
                 ? __ldg(reinterpret_cast<const Word*>(masks_t + s_q[h + k] * cp + first))
                 : Word(0);
    // Byte j of a word is 0 or 1; the product gathers the eight into its
    // top byte.
#pragma unroll
    for (int k = 0; k < 16; ++k)
      s_landed[h + k][lane] = static_cast<uint8_t>(
          (static_cast<unsigned long long>(x[k]) * 0x0102040810204080ull) >> 56);
  }
}

// Warp w of block (x, y) walks segment x * kWarps + w for the L blends
// y * 32 L + lane * L ....  A segment's rows go through the warp 32 at a
// time: lane l loads row l of the next chunk into registers while the warp
// walks the current chunk from shared memory, where it was stored the turn
// before.
template <int L>
__global__ void __launch_bounds__(32 * kWarps) blend_aggregates_kernel(
    const uint8_t* __restrict__ masks_t, int64_t num_blends, int64_t cp, int64_t p,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ before_rb,
    const int32_t* __restrict__ after_rb, const uint8_t* __restrict__ before_lead,
    const uint8_t* __restrict__ after_lead, const float* __restrict__ load_leader,
    const float* __restrict__ load_follower, int64_t num_brokers, float* load,
    int32_t* replica_count, int32_t* leader_count, float* potential_nw_out,
    float* leader_bytes_in) {
  __shared__ int32_t s_q[kWarps][32], s_before[kWarps][32], s_after[kWarps][32];
  __shared__ uint32_t s_lead[kWarps][32];
  __shared__ float4 s_ll[kWarps][32], s_lf[kWarps][32];
  __shared__ uint8_t s_landed[kWarps][32][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (seg >= num_brokers) return;  // the whole warp: no block-wide barrier below
  const int32_t s = static_cast<int32_t>(seg);
  const int64_t first = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * L;
  const bool owns = first < num_blends;
  const int32_t lo = offsets[s], hi = offsets[s + 1];
  RowKey key;
  float4 ll = make_float4(0.f, 0.f, 0.f, 0.f), lf = ll;
  auto fetch = [&](int32_t i) {
    if (i >= hi) return;
    const int64_t r = rows[i];
    key.load(r, partition, p, before_rb, after_rb, before_lead, after_lead);
    const float* l = load_leader + 4 * r;
    const float* f = load_follower + 4 * r;
    ll = make_float4(l[0], l[1], l[2], l[3]);
    lf = make_float4(f[0], f[1], f[2], f[3]);
  };
  float acc[L][6];
  int32_t cnt[L], lcnt[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[j][i] = 0.f;
    cnt[j] = 0;
    lcnt[j] = 0;
  }
  fetch(lo + lane);
  for (int32_t base = lo; base < hi; base += 32) {
    __syncwarp();  // every lane has walked the previous chunk
    s_q[w][lane] = key.q;
    s_before[w][lane] = key.before;
    s_after[w][lane] = key.after;
    s_lead[w][lane] = key.lead;
    s_ll[w][lane] = ll;
    s_lf[w][lane] = lf;
    __syncwarp();
    fetch(base + 32 + lane);
    const int m = min(32, hi - base);
    stage_landed<L>(masks_t, cp, first, owns, s_q[w], m, s_landed[w], lane);
    if (!owns) continue;
    for (int k = 0; k < m; ++k) {
      const uint32_t landed = s_landed[w][k][lane];
      const int32_t sb = s_before[w][k], sa = s_after[w][k];
      const uint32_t leads = s_lead[w][k];
      const float4 l = s_ll[w][k], f = s_lf[w][k];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint32_t in = (landed >> j) & 1u;
        if ((in ? sa : sb) != s) continue;
        const bool lead = (leads >> in) & 1u;
        const float4 row = lead ? l : f;
        acc[j][0] = __fadd_rn(acc[j][0], row.x);
        acc[j][1] = __fadd_rn(acc[j][1], row.y);
        acc[j][2] = __fadd_rn(acc[j][2], row.z);
        acc[j][3] = __fadd_rn(acc[j][3], row.w);
        acc[j][4] = __fadd_rn(acc[j][4], l.z);               // Resource.NW_OUT
        acc[j][5] = __fadd_rn(acc[j][5], lead ? l.y : 0.f);  // Resource.NW_IN of leaders
        cnt[j] += 1;
        lcnt[j] += lead ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t c = first + j;
    if (c >= num_blends) break;
    const int64_t cb = c * num_brokers + s;
    float* out = load + 4 * cb;
    out[0] = acc[j][0];
    out[1] = acc[j][1];
    out[2] = acc[j][2];
    out[3] = acc[j][3];
    potential_nw_out[cb] = acc[j][4];
    leader_bytes_in[cb] = acc[j][5];
    replica_count[cb] = cnt[j];
    leader_count[cb] = lcnt[j];
  }
}

// Cells of a topic-count block's histograms in shared memory (brokers x
// blends x tables, 32 KB).
constexpr int kTopicCells = 8192;

// The (c, topic, broker) replica and leader counts: block (t, y, z) counts
// the rows of topic t (the topic index) that its blends y * blends ... put
// on its brokers z * brokers ... into shared memory with integer atomics
// (exact in any order), then writes each of its cells once, each (c, t)
// row's brokers on consecutive addresses.  A thread takes a row and runs
// through the block's blends.
__global__ void __launch_bounds__(256) blend_topic_counts_kernel(
    const uint8_t* __restrict__ masks_t, int64_t num_blends, int64_t cp, int64_t p,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ before_rb,
    const int32_t* __restrict__ after_rb, const uint8_t* __restrict__ before_lead,
    const uint8_t* __restrict__ after_lead, int64_t num_brokers, int64_t num_topics,
    int blends, int brokers, int32_t* topic_counts, int32_t* topic_leaders) {
  extern __shared__ int32_t s_hist[];  // [tables][blends][brokers]
  const int cells = blends * brokers;
  int32_t* s_cnt = topic_counts != nullptr ? s_hist : nullptr;
  int32_t* s_ld = topic_leaders != nullptr ? s_hist + (s_cnt != nullptr ? cells : 0)
                                           : nullptr;
  const int64_t t = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * blends;
  const int64_t b0 = static_cast<int64_t>(blockIdx.z) * brokers;
  const int nb = static_cast<int>(min(static_cast<int64_t>(brokers), num_brokers - b0));
  const int nc = static_cast<int>(min(static_cast<int64_t>(blends), num_blends - c0));
  const int tables = (s_cnt != nullptr) + (s_ld != nullptr);
  for (int i = threadIdx.x; i < tables * cells; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int64_t lo = offsets[t], hi = offsets[t + 1];
  for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int64_t r = rows[j];
    const uint8_t* m = masks_t + clamp_partition(partition[r], p) * cp + c0;
    const int64_t bb = before_rb[r] - b0, ab = after_rb[r] - b0;
    const bool bl = before_lead[r] != 0, al = after_lead[r] != 0;
#pragma unroll 4
    for (int k = 0; k < nc; ++k) {
      const bool in = m[k] != 0;
      const int64_t b = in ? ab : bb;
      if (b < 0 || b >= nb) continue;
      if (s_cnt != nullptr) atomicAdd(s_cnt + k * brokers + b, 1);
      if (s_ld != nullptr && (in ? al : bl)) atomicAdd(s_ld + k * brokers + b, 1);
    }
  }
  __syncthreads();
  for (int k = 0; k < nc; ++k) {
    const int64_t row = ((c0 + k) * num_topics + t) * num_brokers + b0;
    for (int x = threadIdx.x; x < nb; x += blockDim.x) {
      if (s_cnt != nullptr) topic_counts[row + x] = s_cnt[k * brokers + x];
      if (s_ld != nullptr) topic_leaders[row + x] = s_ld[k * brokers + x];
    }
  }
}

// The sort keys of a row index (kernels.blend_row_index), interleaved by
// row ([r, 2] row-major with an after placement, else [r]): row i's
// before-segment, then its after-segment where that differs; an invalid
// row, a segment outside [0, s) or an unmoved row's after side gets s, past
// every real segment.  cc_argsort's stable order over these keys keeps each
// segment's rows in increasing row order.
__global__ void index_keys_kernel(const int32_t* __restrict__ seg_before,
                                  const int32_t* __restrict__ seg_after,
                                  const uint8_t* __restrict__ valid, int64_t s, int64_t n,
                                  int shift, int32_t* __restrict__ keys) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i >> shift;
    const bool after = (i & shift) != 0;
    const int64_t seg = after ? seg_after[row] : seg_before[row];
    const bool held = valid[row] && seg >= 0 && seg < s && (!after || seg != seg_before[row]);
    keys[i] = static_cast<int32_t>(held ? seg : s);
  }
}

// The CSR from the sorted keys and their positions: rows[i] = position >>
// shift (the row of an interleaved key, in place), and offsets[t] the first
// i whose key is at least t (t in [0, s]), written by the key where the
// segment changes.
__global__ void index_offsets_kernel(const int32_t* __restrict__ keys, int64_t n, int64_t s,
                                     int shift, int32_t* __restrict__ offsets,
                                     int32_t* __restrict__ rows) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t seg = keys[i];
    rows[i] >>= shift;
    const int64_t prev = i == 0 ? -1 : static_cast<int64_t>(keys[i - 1]);
    for (int64_t t = prev + 1; t <= seg && t <= s; ++t) offsets[t] = static_cast<int32_t>(i);
    if (i == n - 1)
      for (int64_t t = seg + 1; t <= s; ++t) offsets[t] = static_cast<int32_t>(n);
  }
}

// masks [C, P] -> masks_t [P, cp] (cp: C rounded up to a multiple of 8,
// the columns past C zero), through 32 x 32 tiles in shared memory.  Block
// (32, 8).
__global__ void masks_by_partition_kernel(const uint8_t* __restrict__ masks, int64_t c,
                                          int64_t cp, int64_t p,
                                          uint8_t* __restrict__ masks_t) {
  __shared__ uint8_t tile[32][33];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * 32;
  const int tx = threadIdx.x;
  for (int k = threadIdx.y; k < 32; k += 8)
    tile[k][tx] = c0 + k < c && p0 + tx < p ? masks[(c0 + k) * p + p0 + tx] : 0;
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += 8)
    if (p0 + k < p && c0 + tx < cp) masks_t[(p0 + k) * cp + c0 + tx] = tile[tx][k];
}

// The same walk over the disk index: the DISK load of each (disk, blend).
template <int L>
__global__ void __launch_bounds__(32 * kWarps) blend_disk_load_kernel(
    const uint8_t* __restrict__ masks_t, int64_t num_blends, int64_t cp, int64_t p,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ before_disk,
    const int32_t* __restrict__ after_disk, const uint8_t* __restrict__ before_lead,
    const uint8_t* __restrict__ after_lead, const float* __restrict__ load_leader,
    const float* __restrict__ load_follower, int64_t num_disks, float* disk_load) {
  __shared__ int32_t s_q[kWarps][32], s_before[kWarps][32], s_after[kWarps][32];
  __shared__ uint32_t s_lead[kWarps][32];
  __shared__ float2 s_disk[kWarps][32];  // DISK of the leader and of the follower row
  __shared__ uint8_t s_landed[kWarps][32][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (seg >= num_disks) return;  // the whole warp: no block-wide barrier below
  const int32_t d = static_cast<int32_t>(seg);
  const int64_t first = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * L;
  const bool owns = first < num_blends;
  const int32_t lo = offsets[d], hi = offsets[d + 1];
  RowKey key;
  float2 v = make_float2(0.f, 0.f);
  auto fetch = [&](int32_t i) {
    if (i >= hi) return;
    const int64_t r = rows[i];
    key.load(r, partition, p, before_disk, after_disk, before_lead, after_lead);
    v = make_float2(load_leader[4 * r + 3], load_follower[4 * r + 3]);
  };
  float acc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = 0.f;
  fetch(lo + lane);
  for (int32_t base = lo; base < hi; base += 32) {
    __syncwarp();  // every lane has walked the previous chunk
    s_q[w][lane] = key.q;
    s_before[w][lane] = key.before;
    s_after[w][lane] = key.after;
    s_lead[w][lane] = key.lead;
    s_disk[w][lane] = v;
    __syncwarp();
    fetch(base + 32 + lane);
    const int m = min(32, hi - base);
    stage_landed<L>(masks_t, cp, first, owns, s_q[w], m, s_landed[w], lane);
    if (!owns) continue;
    for (int k = 0; k < m; ++k) {
      const uint32_t landed = s_landed[w][k][lane];
      const int32_t sb = s_before[w][k], sa = s_after[w][k];
      const uint32_t leads = s_lead[w][k];
      const float2 x = s_disk[w][k];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint32_t in = (landed >> j) & 1u;
        if ((in ? sa : sb) != d) continue;
        acc[j] = __fadd_rn(acc[j], (leads >> in) & 1u ? x.x : x.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (first + j < num_blends) disk_load[(first + j) * num_disks + d] = acc[j];
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

// The blend kernels' launch shape for c blends over s segments: blocks of
// kWarps segments x 32 L blends, L the largest that gives ``busy`` warps;
// false when it does not fit.
bool blend_grid(int64_t c, int64_t s, int64_t busy, dim3* grid, dim3* block,
                int* lane_blends) {
  int l = 8;
  while (l > 1 && s * ((c + 32 * l - 1) / (32 * l)) < busy) l /= 2;
  const int64_t segs = (s + kWarps - 1) / kWarps, groups = (c + 32 * l - 1) / (32 * l);
  if (s >= 0x7fffffff || groups > 65535) return false;
  *grid = dim3(static_cast<unsigned>(segs), static_cast<unsigned>(groups));
  *block = dim3(32 * kWarps);
  *lane_blends = l;
  return true;
}

// The row stride of the masks by partition: c rounded up to a multiple of 8.
int64_t mask_stride(int64_t c) { return (c + 7) / 8 * 8; }

}  // namespace

extern "C" int cc_blend_aggregates(
    int64_t c, int64_t b, int64_t p, int64_t t, const uint8_t* masks_t,
    const int32_t* offsets, const int32_t* rows, const int32_t* topic_offsets,
    const int32_t* topic_rows, const int32_t* partition, const int32_t* before_rb,
    const int32_t* after_rb, const uint8_t* before_lead, const uint8_t* after_lead,
    const float* load_leader, const float* load_follower, float* load,
    int32_t* replica_count, int32_t* leader_count, float* potential_nw_out,
    float* leader_bytes_in, int32_t* topic_counts, int32_t* topic_leaders,
    cudaStream_t stream) {
  if (c <= 0 || b <= 0) return 0;
  const bool topics = topic_counts != nullptr || topic_leaders != nullptr;
  const int64_t cp = mask_stride(c);
  dim3 grid, block;
  int l = 1;
  if (p <= 0 || !blend_grid(c, b, kBusyWarpsAggregates, &grid, &block, &l) ||
      (topics && (t <= 0 || !topic_offsets || !topic_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = l == 8   ? blend_aggregates_kernel<8>
                : l == 4 ? blend_aggregates_kernel<4>
                : l == 2 ? blend_aggregates_kernel<2>
                         : blend_aggregates_kernel<1>;
  kernel<<<grid, block, 0, stream>>>(masks_t, c, cp, p, offsets, rows, partition, before_rb,
                                     after_rb, before_lead, after_lead, load_leader,
                                     load_follower, b, load, replica_count, leader_count,
                                     potential_nw_out, leader_bytes_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !topics) return static_cast<int>(err);
  // A block's histograms: up to kTopicCells / tables brokers, and as many
  // blends (at most 32) as the cells hold.
  const int64_t cells = kTopicCells / ((topic_counts != nullptr) + (topic_leaders != nullptr));
  const int64_t brokers = b < cells ? b : cells;
  int64_t blends = cells / brokers;
  blends = blends < 32 ? blends : 32;
  blends = blends < c ? blends : c;
  const int64_t groups = (c + blends - 1) / blends, tiles = (b + brokers - 1) / brokers;
  if (t > 0x7fffffff || groups > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  blend_topic_counts_kernel<<<dim3(static_cast<unsigned>(t), static_cast<unsigned>(groups),
                                   static_cast<unsigned>(tiles)),
                              256, sizeof(int32_t) * kTopicCells, stream>>>(
      masks_t, c, cp, p, topic_offsets, topic_rows, partition, before_rb, after_rb,
      before_lead, after_lead, b, t, static_cast<int>(blends), static_cast<int>(brokers),
      topic_counts, topic_leaders);
  return static_cast<int>(cudaGetLastError());
}

// Grid of the index kernels' strided loops over n items.
static unsigned index_blocks(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
}

// The int32 keys of a row index over r rows (2 r with seg_after).
extern "C" int cc_blend_index_keys(int64_t r, int64_t s, const int32_t* seg_before,
                                   const int32_t* seg_after, const uint8_t* valid,
                                   int32_t* keys, cudaStream_t stream) {
  const int shift = seg_after != nullptr ? 1 : 0;
  const int64_t n = r << shift;
  if (n <= 0) return 0;
  if (s < 0 || s >= 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  index_keys_kernel<<<index_blocks(n), 256, 0, stream>>>(seg_before, seg_after, valid, s, n,
                                                         shift, keys);
  return static_cast<int>(cudaGetLastError());
}

// offsets i32[s + 1] and rows (i32[n]: cc_argsort's positions on entry)
// from the n sorted keys.
extern "C" int cc_blend_index_offsets(int64_t n, int64_t s, int64_t shift, const int32_t* keys,
                                      int32_t* offsets, int32_t* rows, cudaStream_t stream) {
  if (n <= 0 || s < 0 || (shift != 0 && shift != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  index_offsets_kernel<<<index_blocks(n), 256, 0, stream>>>(keys, n, s,
                                                            static_cast<int>(shift), offsets,
                                                            rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_masks_by_partition(int64_t c, int64_t p, const uint8_t* masks,
                                     uint8_t* masks_t, cudaStream_t stream) {
  if (c <= 0 || p <= 0) return 0;
  const int64_t cp = mask_stride(c);
  const int64_t tiles_p = (p + 31) / 32, tiles_c = (cp + 31) / 32;
  if (tiles_p > 0x7fffffff || tiles_c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  masks_by_partition_kernel<<<dim3(static_cast<unsigned>(tiles_p),
                                   static_cast<unsigned>(tiles_c)),
                              dim3(32, 8), 0, stream>>>(masks, c, cp, p, masks_t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_blend_disk_load(
    int64_t c, int64_t d, int64_t p, const uint8_t* masks_t, const int32_t* offsets,
    const int32_t* rows, const int32_t* partition, const int32_t* before_disk,
    const int32_t* after_disk, const uint8_t* before_lead, const uint8_t* after_lead,
    const float* load_leader, const float* load_follower, float* disk_load,
    cudaStream_t stream) {
  if (c <= 0 || d <= 0) return 0;
  dim3 grid, block;
  int l = 1;
  if (p <= 0 || !blend_grid(c, d, kBusyWarpsDisks, &grid, &block, &l))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = l == 8   ? blend_disk_load_kernel<8>
                : l == 4 ? blend_disk_load_kernel<4>
                : l == 2 ? blend_disk_load_kernel<2>
                         : blend_disk_load_kernel<1>;
  kernel<<<grid, block, 0, stream>>>(masks_t, c, mask_stride(c), p, offsets, rows, partition,
                                     before_disk, after_disk, before_lead, after_lead,
                                     load_leader, load_follower, d, disk_load);
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
  a.replica_disk = nullptr;  // the blend's offline test reads these through the mask
  a.replica_offline = nullptr;
  a.original_broker = nullptr;
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
