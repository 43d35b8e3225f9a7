// K6 top-k — the stable top-k of float32 or int32 (cc_top_k).
//
// Replaces every jax.lax.top_k of the JAX package on the main path: the
// live-lane compaction of select_batched (cruise_control_tpu/analyzer/
// optimizer.py:512, over a mask) and the candidate builders' rankings
// (cruise_control_tpu/analyzer/candidates.py:111,117,195,200,312,460,506,
// 555,570,631,643).  The wrappers and the plain twin: ops/order.py top_k,
// masked_top_k and top_k_plain.
//
// Result, exactly as the plain twin (a stable descending sort of the IEEE
// total-order key of a float32, of an int32 itself, then a slice): the k
// largest entries, +0.0 above -0.0, ties to the lower index, in that order;
// indices as int32 and values x[idx] (-inf where a mask is given and clear).
// (The builders' room order ranks int32 room counts: candidates.py:200.)
//
// Design.  Each entry becomes a 32-bit key d whose ascending order is the
// descending total order of its value (-inf where masked).  Then:
//   1. a radix select of the k-th smallest d, 8 bits a pass, 4 passes over
//      the input; each pass counts the entries that match the digits picked
//      so far in a shared-memory histogram a block, adds it into a global
//      one, and the last block to finish picks the next digit (no host
//      read): T and the number `need` of entries equal to T to take;
//   2. an ordered compaction: a count pass a tile, then a scatter pass that
//      keeps every d < T and the first `need` entries equal to T, at
//      positions from a block scan in index order (no atomics);
//   3. a stable LSD radix sort of the k winners by d, 8 bits a pass (the
//      stage of radix.cuh, shared with argsort.cu): one block in shared
//      memory up to kSmall winners, else the one-sweep sort, a histogram
//      launch for every pass and a launch a pass whose blocks rank their
//      tile's items stably by warp matching from destinations found by a
//      decoupled look-back.
// Up to kSmall entries one block sorts the whole input (no select).  Ties
// keep index order because the compaction keeps it and every sort pass is
// stable.  Every launch runs on the given stream, allocates nothing and
// reads nothing back: the call can be captured into a CUDA graph.
//
// Bound on the card: bytes — the input once (n floats and n mask bytes)
// and k values and indices written.  The select reads the input four times
// and the compaction twice (from L2 at the main path's sizes, n <= 262,144),
// so at these sizes the call is launch-bound: 7 launches and a memset up to
// kSmall winners, 11 and a memset above, 1 for a small input.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using radix::block_exclusive_scan;
using radix::kBins;
using radix::kSmall;
using radix::kThreads;

// The select's and the compaction's tiles: a thread's kItems entries.
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

__host__ __device__ inline int64_t tiles(int64_t n) { return radix::tiles(n, kItems); }

// The select's state words (cleared by one memset a call), then its
// histogram.
enum { kPrefix = 0, kWant = 1, kDone = 2, kLive = 3, kHistAt = 8 };
constexpr int kStateWords = kHistAt + kBins;

constexpr uint32_t kNegInf = 0xFF800000u;  // the bits of -inf

// Ascending d = descending order of the value: the IEEE total order of a
// float32, the order of an int32.
__device__ __forceinline__ uint32_t desc_key(uint32_t b, bool is_int) {
  if (is_int) return b ^ 0x7FFFFFFFu;
  return (b & 0x80000000u) ? b : (~b & 0x7FFFFFFFu);
}

// The entry's 32 bits (-inf where the mask is clear; a mask comes with
// float32 only).
__device__ __forceinline__ uint32_t value_at(const uint32_t* x, const uint8_t* mask,
                                             int64_t i) {
  return (mask != nullptr && mask[i] == 0) ? kNegInf : x[i];
}

__device__ __forceinline__ uint32_t key_at(const uint32_t* x, const uint8_t* mask, int64_t i,
                                           bool is_int) {
  return desc_key(value_at(x, mask, i), is_int);
}

// The sort's items: the compaction's (keys_in, idx_in), or straight from
// the input (keys_in null: key d of entry i, id i).
struct TopkLoad {
  const uint32_t* keys_in;
  const int32_t* idx_in;
  const uint32_t* x;
  const uint8_t* mask;
  bool is_int;
  __device__ uint32_t key(int64_t i) const {
    return keys_in != nullptr ? keys_in[i] : key_at(x, mask, i, is_int);
  }
  __device__ int32_t id(int64_t i) const {
    return keys_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
  }
};

// A pass's items: into (keys_out, idx_out) between passes; after the last
// pass, the first k_out positions get their index and value.
struct TopkStore {
  bool last;
  uint32_t* keys_out;
  int32_t* idx_out;
  const uint32_t* x;
  const uint8_t* mask;
  int64_t k_out;
  uint32_t* out_val;
  int32_t* out_idx;
  __device__ void operator()(int64_t pos, uint32_t key, int32_t id) const {
    if (!last) {
      keys_out[pos] = key;
      idx_out[pos] = id;
    } else if (pos < k_out) {
      out_idx[pos] = id;
      out_val[pos] = value_at(x, mask, id);
    }
  }
};

// ---------------------------------------------------------------------------
// 1. The radix select: one launch a digit, most significant first.
// ---------------------------------------------------------------------------
__global__ void topk_select_kernel(int pass, int64_t n, int64_t k,
                                   const uint32_t* __restrict__ x, bool is_int,
                                   const uint8_t* __restrict__ mask, uint32_t* state,
                                   int32_t* __restrict__ live) {
  __shared__ int hist[kBins];
  __shared__ uint32_t live_sum;
  __shared__ bool last;
  const int shift = 24 - 8 * pass;
  const uint32_t high = pass == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * pass));
  const uint32_t prefix = pass == 0 ? 0u : state[kPrefix];
  hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) live_sum = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kTile);
  const int64_t hi = min(n, lo + kTile);
  uint32_t lives = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t d = key_at(x, mask, i, is_int);
    if ((d & high) == prefix) atomicAdd(&hist[(d >> shift) & 0xFFu], 1);
    if (pass == 0 && mask != nullptr) lives += mask[i] != 0;
  }
  if (pass == 0 && mask != nullptr && lives) atomicAdd(&live_sum, lives);
  __syncthreads();
  if (hist[threadIdx.x]) atomicAdd(&state[kHistAt + threadIdx.x], hist[threadIdx.x]);
  if (threadIdx.x == 0 && pass == 0 && live_sum) atomicAdd(&state[kLive], live_sum);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&state[kDone], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The last block: every block's counts are in the global histogram.
  hist[threadIdx.x] = static_cast<int>(__ldcg(&state[kHistAt + threadIdx.x]));
  state[kHistAt + threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t want = pass == 0 ? static_cast<uint32_t>(k) : __ldcg(&state[kWant]);
    uint32_t acc = 0;
    int digit = kBins - 1;
    for (int b = 0; b < kBins; ++b) {
      if (acc + static_cast<uint32_t>(hist[b]) >= want) {
        digit = b;
        break;
      }
      acc += hist[b];
    }
    state[kPrefix] = prefix | (static_cast<uint32_t>(digit) << shift);
    state[kWant] = want - acc;
    state[kDone] = 0;
    if (pass == 0 && live != nullptr) *live = static_cast<int32_t>(__ldcg(&state[kLive]));
  }
}

// ---------------------------------------------------------------------------
// 2. The ordered compaction: counts a tile, then the winners in index order.
// A thread holds kItems consecutive entries of its block's tile.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t lt_eq(uint32_t d, uint32_t t) {
  return d < t ? (1u << 16) : (d == t ? 1u : 0u);  // (lt << 16) | eq, <= kTile each
}

__global__ void topk_count_kernel(int64_t n, const uint32_t* __restrict__ x, bool is_int,
                                  const uint8_t* __restrict__ mask,
                                  const uint32_t* __restrict__ state,
                                  uint32_t* __restrict__ tile_counts) {
  const uint32_t t = state[kPrefix];
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kTile);
  const int64_t hi = min(n, lo + kTile);
  uint32_t c = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
    c += lt_eq(key_at(x, mask, i, is_int), t);
  uint32_t total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void topk_compact_kernel(int64_t n, const uint32_t* __restrict__ x, bool is_int,
                                    const uint8_t* __restrict__ mask,
                                    const uint32_t* __restrict__ state,
                                    const uint32_t* __restrict__ tile_counts,
                                    uint32_t* __restrict__ keys_out,
                                    int32_t* __restrict__ idx_out) {
  __shared__ uint32_t before_lt, before_eq;
  const uint32_t t = state[kPrefix], need = state[kWant];
  if (threadIdx.x == 0) {
    uint32_t l = 0, e = 0;
    for (unsigned b = 0; b < blockIdx.x; ++b) {
      l += tile_counts[b] >> 16;
      e += tile_counts[b] & 0xFFFFu;
    }
    before_lt = l;
    before_eq = e;
  }
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kTile) +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  const int64_t hi = min(n, lo + kItems);
  uint32_t c = 0;
  for (int64_t i = lo; i < hi; ++i) c += lt_eq(key_at(x, mask, i, is_int), t);
  uint32_t total;
  uint32_t mine = block_exclusive_scan(c, &total);  // (lt, eq) before my entries
  const uint32_t eq_room = before_eq >= need ? 0u : need - before_eq;  // T-ties left to take
  const uint32_t base = before_lt + min(before_eq, need);
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t d = key_at(x, mask, i, is_int);
    const uint32_t lt = mine >> 16, eq = mine & 0xFFFFu;
    if (d < t || (d == t && eq < eq_room)) {
      const uint32_t pos = base + lt + min(eq, eq_room);
      keys_out[pos] = d;
      idx_out[pos] = static_cast<int32_t>(i);
    }
    mine += lt_eq(d, t);
  }
}

// ---------------------------------------------------------------------------
// 3. The stable LSD radix sort of the winners.
// ---------------------------------------------------------------------------

// One block sorts m <= kSmall items and writes the first k_out: from keys
// and indices (keys_in non-null) or straight from the input (index = i).
// live (non-null, input path with a mask): the count of set mask bytes.
__global__ void topk_block_sort_kernel(int64_t m, int64_t k_out,
                                       const uint32_t* __restrict__ keys_in,
                                       const int32_t* __restrict__ idx_in,
                                       const uint32_t* __restrict__ x, bool is_int,
                                       const uint8_t* __restrict__ mask,
                                       uint32_t* __restrict__ out_val,
                                       int32_t* __restrict__ out_idx,
                                       int32_t* __restrict__ live) {
  if (live != nullptr) {
    uint32_t lives = 0;
    for (int i = threadIdx.x; i < m; i += kThreads) lives += mask[i] != 0;
    uint32_t total;
    block_exclusive_scan(lives, &total);
    if (threadIdx.x == 0) *live = static_cast<int32_t>(total);
  }
  radix::block_sort(static_cast<int>(m), 4, TopkLoad{keys_in, idx_in, x, mask, is_int},
                    TopkStore{true, nullptr, nullptr, x, mask, k_out, out_val, out_idx});
}

// Above kSmall winners: the one-sweep sort (radix.cuh); the winners' keys
// come from the compaction, or from the input when every entry wins
// (keys_in null).
__global__ void topk_hist_kernel(int64_t m, const uint32_t* __restrict__ keys_in,
                                 const uint32_t* __restrict__ x, bool is_int,
                                 const uint8_t* __restrict__ mask, uint32_t* sweep) {
  radix::sweep_hist(m, 4, TopkLoad{keys_in, nullptr, x, mask, is_int}, sweep);
}

// A pass of the sweep; the last pass writes the first k_out indices and
// their values.
__global__ void topk_scatter_kernel(int pass, int64_t m, int64_t k_out,
                                    const uint32_t* __restrict__ keys_in,
                                    const int32_t* __restrict__ idx_in,
                                    const uint32_t* __restrict__ x, bool is_int,
                                    const uint8_t* __restrict__ mask, uint32_t* sweep,
                                    uint32_t* __restrict__ keys_out,
                                    int32_t* __restrict__ idx_out,
                                    uint32_t* __restrict__ out_val,
                                    int32_t* __restrict__ out_idx) {
  radix::sweep_pass(pass, m, TopkLoad{keys_in, idx_in, x, mask, is_int}, sweep,
                    TopkStore{pass == 3, keys_out, idx_out, x, mask, k_out, out_val, out_idx});
}

// The scratch, in words: the select's state, the sweep's words (above
// kSmall winners), the compaction's tile counts, two buffers of keys and
// indices.  One memset a call zeroes the state and the sweep's words.
int64_t sweep_words(int64_t k) { return k > kSmall ? radix::sweep_words(k) : 0; }

int64_t work_words(int64_t n, int64_t k) {
  return kStateWords + sweep_words(k) + tiles(n) + 4 * k;
}

}  // namespace

// values (the entries' 32 bits) and indices i32[k] of the k largest of x[n]
// (float32, or int32 with is_int; mask: u8[n] or null, float32 only, a
// clear byte counting as -inf); live (i32[1] or null, with a mask): the
// count of set mask bytes; k <= 2^30 - 1 above kSmall.  work (above kSmall
// entries): i32 scratch of at least work_words(n, k) = kStateWords +
// tiles(n) + 4 k words (tiles(n) = ceil(n / 4096)), plus
// radix::sweep_words(k) = 1,032 + 1,024 ceil(k / 1024) above kSmall
// winners: the wrapper's `_top_k_work_words`.
extern "C" int cc_top_k(int64_t n, int64_t k, int64_t is_int, const uint32_t* x,
                        const uint8_t* mask, uint32_t* out_val, int32_t* out_idx, int32_t* live,
                        int32_t* work, int64_t work_size, cudaStream_t stream) {
  if (k <= 0 || k > n || n > 0x7FFFFFFF || (is_int && mask != nullptr) ||
      (k > kSmall && k > radix::kSweepMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool as_int = is_int != 0;
  if (n <= kSmall) {
    topk_block_sort_kernel<<<1, kThreads, 0, stream>>>(n, k, nullptr, nullptr, x, as_int, mask,
                                                        out_val, out_idx,
                                                        mask != nullptr ? live : nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  if (work_size < work_words(n, k)) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* state = reinterpret_cast<uint32_t*>(work);
  uint32_t* sweep = state + kStateWords;
  uint32_t* tile_counts = sweep + sweep_words(k);
  uint32_t* keys_a = tile_counts + tiles(n);
  int32_t* idx_a = reinterpret_cast<int32_t*>(keys_a + k);
  uint32_t* keys_b = reinterpret_cast<uint32_t*>(idx_a + k);
  int32_t* idx_b = reinterpret_cast<int32_t*>(keys_b + k);
  cudaMemsetAsync(state, 0, sizeof(uint32_t) * (kStateWords + sweep_words(k)), stream);
  const uint32_t* keys_in = nullptr;  // null: the keys come from x (k == n)
  const int32_t* idx_in = nullptr;
  if (k < n) {
    const unsigned grid = static_cast<unsigned>(tiles(n));
    for (int pass = 0; pass < 4; ++pass)
      topk_select_kernel<<<grid, kThreads, 0, stream>>>(pass, n, k, x, as_int, mask, state,
                                                        live);
    topk_count_kernel<<<grid, kThreads, 0, stream>>>(n, x, as_int, mask, state, tile_counts);
    topk_compact_kernel<<<grid, kThreads, 0, stream>>>(n, x, as_int, mask, state, tile_counts,
                                                       keys_a, idx_a);
    keys_in = keys_a;
    idx_in = idx_a;
  } else if (live != nullptr && mask != nullptr) {
    // Every entry wins: the select's first pass only counts the mask.
    topk_select_kernel<<<static_cast<unsigned>(tiles(n)), kThreads, 0, stream>>>(
        0, n, k, x, as_int, mask, state, live);
  }
  if (k <= kSmall) {
    topk_block_sort_kernel<<<1, kThreads, 0, stream>>>(k, k, keys_in, idx_in, x, as_int, mask,
                                                        out_val, out_idx, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned grid = static_cast<unsigned>(radix::sweep_tiles(k));
  topk_hist_kernel<<<grid, kThreads, 0, stream>>>(k, keys_in, x, as_int, mask, sweep);
  for (int pass = 0; pass < 4; ++pass) {
    uint32_t* keys_out = (pass & 1) ? keys_a : keys_b;
    int32_t* idx_out = (pass & 1) ? idx_a : idx_b;
    topk_scatter_kernel<<<grid, kThreads, 0, stream>>>(pass, k, k, keys_in, idx_in, x, as_int,
                                                       mask, sweep, keys_out, idx_out, out_val,
                                                       out_idx);
    keys_in = keys_out;
    idx_in = idx_out;
  }
  return static_cast<int>(cudaGetLastError());
}
