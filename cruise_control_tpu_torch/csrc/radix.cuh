// The stable LSD radix sort stage shared by cc_top_k (top_k.cu) and
// cc_argsort / cc_row_argsort (argsort.cu).
//
// Items are (key, id) pairs: a 32-bit key whose ascending unsigned order is
// the wanted order, and an int32 id (an index of the input).  A pass ranks
// the items by 8 bits of the key, least significant first, and keeps the
// order of equal digits, so after the passes that cover the key's bits the
// items stand in ascending key order with ties in id order, as long as the
// first pass read them in id order.
//
//   - rank_tile: a block ranks a tile's items by one digit, stably, with two
//     block barriers: each warp counts the digits of its contiguous share of
//     the tile (equal digits of a step grouped by warp matching), thread d
//     turns digit d's counts into each warp's first destination, and each
//     warp walks its share again in order.
//   - block_sort: one block sorts up to kSmall items in shared memory, one
//     rank_tile a pass.
//   - sweep_hist + sweep_pass: the one-sweep sort of more items.  One
//     histogram launch counts every pass's digits in one read of the input;
//     then a launch a pass over tiles of kSweepTile items, each block taking
//     the next tile in start order and ranking it with rank_tile from its
//     digits' first destinations: the pass's count of the lower digits plus
//     the digit's count in the earlier tiles, found by a decoupled
//     look-back (LookbackStart).
//
// A Load gives item i: `key(i)` and `id(i)`.  A Store takes the item that
// lands at sorted position `pos`: `operator()(pos, key, id)`.  Each of
// block_sort, sweep_hist and sweep_pass holds its own shared memory, once
// for every (Load, Store) type it is instantiated with in a kernel, so a
// kernel instantiates each with one pair of types (a source's Load and
// Store choose their input and output at run time).  Nothing here
// allocates, synchronises the host or reads anything back, so every launch
// built on it can be captured into a CUDA graph.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kSmall = 2048;  // one block sorts up to this many

// Tiles of kThreads x steps items over m items.
__host__ __device__ inline int64_t tiles(int64_t m, int steps) {
  const int64_t tile = static_cast<int64_t>(kThreads) * steps;
  return (m + tile - 1) / tile;
}

// Exclusive scan of one value a thread over the block (kThreads threads);
// *total gets the block's sum.  Every thread must call it.
__device__ inline uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    uint32_t winc = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += t;
    }
    if (lane < kWarps) warp_sums[lane] = winc - w;
    if (lane == kWarps - 1) warp_sums[kWarps] = winc;
  }
  __syncthreads();
  const uint32_t out = warp_sums[warp] + inc - v;
  *total = warp_sums[kWarps];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// A tile's item layout for `steps` steps a warp: warp w holds the tile's
// items [w * 32 steps, (w + 1) * 32 steps) in steps of 32, item
// w * 32 steps + 32 s + lane in its registers at step s; items at or past
// `count` are invalid.
__device__ __forceinline__ int tile_item(int step, int steps) {
  return (threadIdx.x >> 5) * 32 * steps + 32 * step + (threadIdx.x & 31);
}

// The tile's first destination of digit d from the digits' counts in it.
// One block alone: an exclusive scan of the counts over the block (every
// thread must call it, thread d with digit d).
struct ScanStart {
  __device__ int operator()(int, int total) const {
    uint32_t all;
    return static_cast<int>(block_exclusive_scan(static_cast<uint32_t>(total), &all));
  }
};

// Ranks a tile's items stably by the 8-bit digit at `shift` and hands each
// to `store` at its destination.  Each warp counts its own items' digits
// (equal digits of a step grouped by __match_any_sync, one add a group),
// thread d turns digit d's counts into each warp's first destination
// (start(d, total) plus the counts of the warps before), and each warp then
// walks its items again in order, a step's equal digits taking consecutive
// slots in lane order.  Two block barriers a tile.  The warps hold `steps`
// steps each (at most kSteps, the registers' size).  offs: shared,
// kWarps x kBins.  Every thread must call it.
template <int kSteps, class Start, class Store>
__device__ void rank_tile(const uint32_t (&keys)[kSteps], const int32_t (&ids)[kSteps],
                          int steps, int count, int shift, int* offs, const Start& start,
                          const Store& store) {
  static_assert(kThreads == kBins, "thread d owns digit d");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* mine = offs + warp * kBins;
  for (int b = lane; b < kBins; b += 32) mine[b] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (s == steps) break;
    const bool valid = tile_item(s, steps) < count;
    const uint32_t d = valid ? (keys[s] >> shift) & 0xFFu : static_cast<uint32_t>(kBins);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += offs[w * kBins + d];
    int at = start(d, total);
    for (int w = 0; w < kWarps; ++w) {
      const int c = offs[w * kBins + d];
      offs[w * kBins + d] = at;
      at += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (s == steps) break;
    const bool valid = tile_item(s, steps) < count;
    const uint32_t d = valid ? (keys[s] >> shift) & 0xFFu : static_cast<uint32_t>(kBins);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int pos = 0;
    if (valid) pos = mine[d] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
    if (valid) store(pos, keys[s], ids[s]);
  }
  __syncthreads();  // offs is reused by the next tile or pass
}

// Writes a pass's items into shared memory for the next pass.
struct SharedStore {
  uint32_t* keys;
  int32_t* ids;
  __device__ void operator()(int pos, uint32_t key, int32_t id) const {
    keys[pos] = key;
    ids[pos] = id;
  }
};

constexpr int kSmallSteps = kSmall / kThreads;  // a warp's most steps in one block's sort

// One block (kThreads threads) sorts the m <= kSmall items of `load` by the
// low 8 * passes bits of their keys (1 <= passes <= 4) and hands each to
// `store` at its sorted position, in ceil(m / kThreads) steps a warp (a
// short input spread over every warp).  Every thread must call it.
template <class Load, class Store>
__device__ void block_sort(int m, int passes, const Load& load, const Store& store) {
  __shared__ uint32_t keys[2][kSmall];
  __shared__ int32_t ids[2][kSmall];
  __shared__ int offs[kWarps * kBins];
  for (int i = threadIdx.x; i < m; i += kThreads) {
    keys[0][i] = load.key(i);
    ids[0][i] = load.id(i);
  }
  __syncthreads();
  const int steps = (m + kThreads - 1) / kThreads;
  for (int pass = 0; pass < passes; ++pass) {
    const int src = pass & 1;
    uint32_t k[kSmallSteps];
    int32_t id[kSmallSteps];
#pragma unroll
    for (int s = 0; s < kSmallSteps; ++s) {
      const int i = tile_item(s, steps);
      k[s] = s < steps && i < m ? keys[src][i] : 0u;
      id[s] = s < steps && i < m ? ids[src][i] : 0;
    }
    if (pass < passes - 1)
      rank_tile(k, id, steps, m, 8 * pass, offs, ScanStart{},
                SharedStore{keys[src ^ 1], ids[src ^ 1]});
    else
      rank_tile(k, id, steps, m, 8 * pass, offs, ScanStart{}, store);
  }
}

// ---------------------------------------------------------------------------
// The one-sweep sort of more than kSmall items: one histogram launch for
// every pass (sweep_hist), then one launch a pass (sweep_pass) over tiles of
// kSweepTile items whose blocks find their destinations by a decoupled
// look-back.  The scratch (sweep_words words, zeroed once a call for the
// passes it runs): the passes' tile counters (kSweepCountsAt words), their
// global digit counts (4 x kBins), their look-back status (4 x tiles x
// kBins).
// ---------------------------------------------------------------------------

constexpr int kSweepSteps = 4;                      // a warp's steps in a sweep tile
constexpr int kSweepTile = kThreads * kSweepSteps;  // 1,024 items
constexpr int64_t kSweepCountsAt = 8;
constexpr int64_t kSweepStatusAt = kSweepCountsAt + 4 * kBins;

__host__ __device__ inline int64_t sweep_tiles(int64_t m) { return tiles(m, kSweepSteps); }

// Words of the sweep's scratch for m items and `passes` passes (the words a
// call zeroes; 4 passes: the words it must be given).
__host__ __device__ inline int64_t sweep_words(int64_t m, int passes = 4) {
  return kSweepStatusAt + static_cast<int64_t>(passes) * kBins * sweep_tiles(m);
}

// The look-back status of a (pass, tile, digit): the tile's count of the
// digit (kAggregate) or the count of the digit up to and including the tile
// (kInclusive), in the low 30 bits; 0 until the tile publishes.  A sweep
// takes at most kSweepMax items.
constexpr uint32_t kInclusive = 0x80000000u;
constexpr uint32_t kAggregate = 0x40000000u;
constexpr uint32_t kCountMask = 0x3FFFFFFFu;
constexpr int64_t kSweepMax = kCountMask;

// A status word carries its whole message (flag and count), so relaxed
// device-scope accesses suffice: no other data is published with it.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

constexpr int kLookback = 8;  // earlier tiles' words a look-back step reads at once

// Digit d's first destination in this tile: the pass's count of the digits
// below d (a block scan of the global counts) plus the digit's count in the
// tiles before, found by a decoupled look-back: thread d publishes its
// tile's count, adds the earlier tiles' counts walking back (kLookback
// words in flight at a time) until a tile whose inclusive count is
// published, and publishes its own inclusive count.  Tiles are numbered in
// the order their blocks start (the pass's tile counter), so every tile
// waited on belongs to a block that runs or has run.
struct LookbackStart {
  const uint32_t* counts;  // [kBins], this pass
  uint32_t* status;        // [tiles][kBins], this pass
  int64_t tile;
  __device__ int operator()(int d, int total) const {
    uint32_t all;
    const uint32_t base = block_exclusive_scan(counts[d], &all);
    uint32_t* mine = status + tile * kBins + d;
    const uint32_t count = static_cast<uint32_t>(total);
    if (tile == 0) {
      store_status(mine, kInclusive | count);
      return static_cast<int>(base);
    }
    store_status(mine, kAggregate | count);
    uint32_t before = 0;
    for (int64_t b = tile - 1;;) {
      uint32_t v[kLookback];
#pragma unroll
      for (int j = 0; j < kLookback; ++j)  // tile 0 is inclusive: the walk ends there
        v[j] = b - j >= 0 ? load_status(status + (b - j) * kBins + d) : 0u;
      bool found = false;
      int used = 0;
      for (; used < kLookback && v[used] != 0u; ++used) {
        before += v[used] & kCountMask;
        if (v[used] & kInclusive) {
          found = true;
          break;
        }
      }
      if (found) break;
      b -= used;  // past the aggregates read; a word not yet published is read again
    }
    store_status(mine, kInclusive | (before + count));
    return static_cast<int>(base + before);
  }
};

// Every pass's global digit counts in one read of the m items of `load` (a
// digit's count does not depend on the order the earlier passes leave), a
// launch over sweep_tiles(m) blocks: each block counts its tile (equal
// digits of a warp's step: one add), then adds its counts into
// words[kSweepCountsAt + pass * kBins + digit].
template <class Load>
__device__ void sweep_hist(int64_t m, int passes, const Load& load, uint32_t* words) {
  __shared__ int tile_counts[4][kBins];
  for (int p = 0; p < 4; ++p) tile_counts[p][threadIdx.x] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kSweepTile);
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kSweepSteps; ++r) {
    const int64_t i = lo + r * kThreads + threadIdx.x;
    const bool valid = i < m;
    const uint32_t key = valid ? load.key(i) : 0u;
    for (int p = 0; p < passes; ++p) {
      const uint32_t d = valid ? (key >> (8 * p)) & 0xFFu : static_cast<uint32_t>(kBins);
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&tile_counts[p][d], __popc(peers));
    }
  }
  __syncthreads();
  uint32_t* counts = words + kSweepCountsAt;
  for (int p = 0; p < passes; ++p)
    if (tile_counts[p][threadIdx.x])
      atomicAdd(&counts[p * kBins + threadIdx.x],
                static_cast<uint32_t>(tile_counts[p][threadIdx.x]));
}

// Pass `pass` over the m items of `load`, a launch over sweep_tiles(m)
// blocks after sweep_hist: the block takes the next tile in start order,
// loads its items (a warp's kSweepSteps steps), ranks them (rank_tile) from
// the look-back's destinations and hands each to `store`.
template <class Load, class Store>
__device__ void sweep_pass(int pass, int64_t m, const Load& load, uint32_t* words,
                           const Store& store) {
  __shared__ int offs[kWarps * kBins];
  __shared__ int64_t tile_of_block;
  if (threadIdx.x == 0) tile_of_block = atomicAdd(words + pass, 1u);
  __syncthreads();
  const int64_t tile = tile_of_block;
  const int64_t lo = tile * kSweepTile;
  const int count = static_cast<int>(min(static_cast<int64_t>(kSweepTile), m - lo));
  uint32_t k[kSweepSteps];
  int32_t id[kSweepSteps];
#pragma unroll
  for (int s = 0; s < kSweepSteps; ++s) {
    const int i = tile_item(s, kSweepSteps);
    k[s] = i < count ? load.key(lo + i) : 0u;
    id[s] = i < count ? load.id(lo + i) : 0;
  }
  rank_tile(k, id, kSweepSteps, count, 8 * pass, offs,
            LookbackStart{words + kSweepCountsAt + pass * kBins,
                          words + kSweepStatusAt + pass * sweep_tiles(m) * kBins, tile},
            store);
}

}  // namespace radix
