// K6 group rank — each row's rank within its group by descending key
// (cc_group_rank).
//
// Replaces _within_group_rank of cruise_control_tpu/analyzer/goals/
// kernels.py:791-805 (its lexsort, the sorted groups' starts, the cummax and
// the scatter back), which source_replica_relevance calls at :754 (the
// (topic, broker) pairs of TopicReplicaDistributionGoal) and :788 (the
// brokers of the count and load goals).  The wrapper and the plain twin:
// analyzer/goals/kernels.py _within_group_rank and within_group_rank_plain.
//
//   rank(i) = #{ j in group(i) : key[j] > key[i], or key[j] == key[i] and j < i }
//
// with the keys compared after canonicalisation (-0.0 equals +0.0), as the
// JAX package's stable lexsort of -key orders them.  Each row becomes one
// 64-bit composite, (order key of the value) << 32 | ~row, so the rank is the
// count of the group's composites above the row's own.
//
// Design: the rank does not depend on the order in which a group's rows are
// visited, so the rows are grouped without any sort: a count of each group
// by atomics, one block's exclusive scan of the counts, a scatter of each
// row's composite into its group's range (a slot by atomic decrement of the
// count), then one thread a grouped position counts its group's composites
// above its own.  Neighbouring threads mostly share a group, so their reads
// of the group's range are broadcasts; a block whose positions all lie in
// one group (a group of more than a block's rows: a skewed broker) walks
// the range through shared memory in tiles instead.  The work is the sum of
// the groups' squared sizes: about 500 rows a broker at the large rung.
// Group ids outside [0, S) form one extra group (the wrapper's callers pass
// none).  Five device ops, no host read: the call can be captured.
//
// Bound on the card: bytes (N ids and keys read, N ranks written); the
// grouping's scratch (12 N + 8 S bytes) stays in L2 at the main path's sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int64_t slot_of(int32_t g, int64_t s) {
  return (g >= 0 && g < s) ? g : s;
}

// (order key of the canonical value) << 32 | ~row: above another row's
// composite iff its value is larger, or equal with a lower row.
__device__ __forceinline__ uint64_t composite(float key, int64_t row) {
  const uint32_t b = __float_as_uint(__fadd_rn(key, 0.0f));  // -0.0 -> +0.0
  const uint32_t u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(row));
}

__global__ void rank_count_kernel(int64_t n, int64_t s, const int32_t* __restrict__ group,
                                  int32_t* __restrict__ counts) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i < n) atomicAdd(&counts[slot_of(group[i], s)], 1);
}

// One block: offsets[g] = counts of the groups before g (g <= m), in chunks
// of consecutive groups a thread.
__global__ void rank_scan_kernel(int64_t m, const int32_t* __restrict__ counts,
                                 int32_t* __restrict__ offsets) {
  __shared__ int32_t warp_sums[kScanThreads / 32 + 1];
  const int64_t per = (m + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per, hi = min(m, lo + per);
  int32_t sum = 0;
  for (int64_t g = lo; g < hi; ++g) sum += counts[g];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_sums[lane];
    int32_t winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += t;
    }
    warp_sums[lane] = winc - w;
    if (lane == 31) warp_sums[32] = winc;
  }
  __syncthreads();
  int32_t at = warp_sums[warp] + inc - sum;
  for (int64_t g = lo; g < hi; ++g) {
    offsets[g] = at;
    at += counts[g];
  }
  if (threadIdx.x == 0) offsets[m] = warp_sums[32];
}

// Each row's composite and group slot into its group's range; the counts
// run down to 0 (the slot within the range is arbitrary).
__global__ void rank_scatter_kernel(int64_t n, int64_t s, const int32_t* __restrict__ group,
                                    const float* __restrict__ key,
                                    const int32_t* __restrict__ offsets,
                                    int32_t* __restrict__ counts, uint64_t* __restrict__ comp,
                                    int32_t* __restrict__ slots) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n) return;
  const int64_t g = slot_of(group[i], s);
  const int32_t pos = offsets[g] + atomicSub(&counts[g], 1) - 1;
  comp[pos] = composite(key[i], i);
  slots[pos] = static_cast<int32_t>(g);
}

// One thread a grouped position p: its row's rank is the count of its
// group's composites above its own.
__global__ void rank_count_above_kernel(int64_t n, const uint64_t* __restrict__ comp,
                                        const int32_t* __restrict__ slots,
                                        const int32_t* __restrict__ offsets,
                                        int32_t* __restrict__ out) {
  __shared__ uint64_t tile[kThreads];
  const int64_t first = blockIdx.x * static_cast<int64_t>(kThreads);
  const int64_t last = min(n, first + kThreads) - 1;
  const int64_t p = first + threadIdx.x;
  const bool valid = p < n;
  const uint64_t mine = valid ? comp[p] : 0;
  const int32_t g = valid ? slots[p] : slots[last];
  const int32_t lo = offsets[g], hi = offsets[g + 1];
  int32_t above = 0;
  if (slots[first] == slots[last] && hi - lo > kThreads) {
    // Every position of the block in one large group: tiles of its range
    // through shared memory (a zero composite is above none).
    for (int32_t base = lo; base < hi; base += kThreads) {
      const int32_t q = base + threadIdx.x;
      tile[threadIdx.x] = q < hi ? comp[q] : 0;
      __syncthreads();
      const int m = min(kThreads, hi - base);
      for (int j = 0; j < m; ++j) above += tile[j] > mine;
      __syncthreads();
    }
  } else if (valid) {
    for (int32_t q = lo; q < hi; ++q) above += comp[q] > mine;
  }
  if (valid) out[~static_cast<uint32_t>(mine)] = above;
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// out i32[n]: each row's rank within its group (group i32[n], ids in [0, s);
// key f32[n], not NaN).  work: i32 scratch of at least 3 n + 2 (s + 1) + 1
// words (the wrapper's `words` in _within_group_rank); its start 8-byte
// aligned.
extern "C" int cc_group_rank(int64_t n, int64_t s, const int32_t* group, const float* key,
                             int32_t* out, int32_t* work, int64_t work_size,
                             cudaStream_t stream) {
  if (n < 0 || s < 0 || n > 0x7FFFFFFF || s >= 0x7FFFFFFF ||
      work_size < 3 * n + 2 * (s + 1) + 1 || (reinterpret_cast<uintptr_t>(work) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  uint64_t* comp = reinterpret_cast<uint64_t*>(work);
  int32_t* slots = work + 2 * n;
  int32_t* counts = slots + n;       // s + 1 groups (the last: ids out of range)
  int32_t* offsets = counts + s + 1;  // s + 2
  cudaMemsetAsync(counts, 0, sizeof(int32_t) * (s + 1), stream);
  rank_count_kernel<<<blocks_for(n), kThreads, 0, stream>>>(n, s, group, counts);
  rank_scan_kernel<<<1, kScanThreads, 0, stream>>>(s + 1, counts, offsets);
  rank_scatter_kernel<<<blocks_for(n), kThreads, 0, stream>>>(n, s, group, key, offsets, counts,
                                                              comp, slots);
  rank_count_above_kernel<<<blocks_for(n), kThreads, 0, stream>>>(n, comp, slots, offsets, out);
  return static_cast<int>(cudaGetLastError());
}
