// K6 — the matched-transport legs' rank and slot lookup.
//
// Replaces the non-library parts of cruise_control_tpu/analyzer/
// candidates.py:136 _matched_move_legs and :254 _matched_topic_legs:
//   cc_transport_rank:   each row's rank among the rows of its group, from
//                        the stable sort's order (the segment-start
//                        scatter-min and the rank scatter);
//   cc_transport_lookup: for each lane, the slot it takes in its window of
//                        prefix-summed slot sizes (the index_add_ count +
//                        cumsum of the move legs, the global searchsorted
//                        of the topic legs): the broker of that slot, of
//                        the window's next slot, and whether the window
//                        holds that many units.  One window of width B
//                        (move legs: win = 0, offset = lane index) or T
//                        windows of width 2B (topic legs).
// The stable sorts and top-k around them stay library calls (ops.order).
//
// Bound on the card: bytes (rank: N * 12 read, N * 4 written; lookup: L * 8
// read plus the window's prefix sums, L * 9 written), a few hundred KB at
// the mid rung, so both are launch-bound.
//
// Design: one thread per sorted position (rank) or per lane (lookup), each
// with a binary search (the group's first sorted position; the window's
// first prefix sum above the target).  All outputs are integers or flags,
// so they equal the plain versions exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void transport_rank_kernel(const int64_t* __restrict__ order,
                                      const int32_t* __restrict__ key, int64_t n,
                                      int32_t* __restrict__ rank) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int32_t g = key[order[p]];
  // First sorted position whose key is g (keys ascend along order).
  int64_t lo = 0, hi = p;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (key[order[mid]] < g) lo = mid + 1; else hi = mid;
  }
  rank[order[p]] = static_cast<int32_t>(p - lo);
}

__global__ void transport_lookup_kernel(const int32_t* __restrict__ cum,
                                        const int32_t* __restrict__ slot_broker,
                                        const int32_t* __restrict__ win,
                                        const int32_t* __restrict__ off, int64_t n,
                                        int64_t width, int32_t* __restrict__ dest1,
                                        int32_t* __restrict__ dest2,
                                        uint8_t* __restrict__ ok) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t first = static_cast<int64_t>(win[i]) * width;
  const int64_t last = first + width - 1;
  const int32_t base = first > 0 ? cum[first - 1] : 0;
  const int32_t target = base + off[i];
  // First slot of the window whose running total exceeds target, else the
  // window's last slot.
  int64_t lo = first, hi = last + 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (cum[mid] <= target) lo = mid + 1; else hi = mid;
  }
  const int64_t j = lo < last ? lo : last;
  dest1[i] = slot_broker[j];
  dest2[i] = slot_broker[j + 1 < last ? j + 1 : last];
  ok[i] = off[i] < cum[last] - base;
}

}  // namespace

extern "C" int cc_transport_rank(const int64_t* order, const int32_t* key, int64_t n,
                                 int32_t* rank, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  transport_rank_kernel<<<blocks, kThreads, 0, stream>>>(order, key, n, rank);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_transport_lookup(const int32_t* cum, const int32_t* slot_broker,
                                   const int32_t* win, const int32_t* off, int64_t n,
                                   int64_t width, int32_t* dest1, int32_t* dest2,
                                   uint8_t* ok, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  transport_lookup_kernel<<<blocks, kThreads, 0, stream>>>(
      cum, slot_broker, win, off, n, width, dest1, dest2, ok);
  return static_cast<int>(cudaGetLastError());
}
