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
//   3. a stable LSD radix sort of the k winners by d, 8 bits a pass: one
//      block in shared memory up to kSmall winners, else a histogram launch
//      a pass (its last block scans the counts) and a scatter launch a pass
//      whose blocks rank their tile's items stably by warp matching.
// Up to kSmall entries one block sorts the whole input (no select).  Ties
// keep index order because the compaction keeps it and every sort pass is
// stable.  Every launch runs on the given stream, allocates nothing and
// reads nothing back: the call can be captured into a CUDA graph.
//
// Bound on the card: bytes — the input once (n floats and n mask bytes)
// and k values and indices written.  The select reads the input four times
// and the compaction twice (from L2 at the main path's sizes, n <= 262,144),
// so at these sizes the call is launch-bound: 7 launches and a memset up to
// kSmall winners, 13 and a memset above, 1 for a small input.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // entries a block handles a pass
constexpr int kBins = 256;
constexpr int kSmall = 2048;              // one block sorts up to this many

// The select's state words (cleared by one memset a call), then its
// histogram.
enum { kPrefix = 0, kWant = 1, kDone = 2, kLive = 3, kHistAt = 8 };
constexpr int kStateWords = kHistAt + kBins;

__host__ __device__ inline int64_t tiles(int64_t m) { return (m + kTile - 1) / kTile; }

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

// Exclusive scan of one value a thread over the block (kThreads threads);
// *total gets the block's sum.  Every thread must call it.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
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

// The stable destination of this round's item (one a thread, the round's
// items in thread order) among the items of its digit: run[digit] (the
// digit's next slot, shared) plus the same-digit items of earlier warps and
// lanes of the round; advances run[] past the round.  wcount (shared,
// kWarps x kBins) must be zero on entry and is zero again on exit.  An
// invalid item (digit == kBins) gets no slot.  Every thread must call it.
__device__ int round_rank(uint32_t digit, bool valid, int* run, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t d = valid ? digit : static_cast<uint32_t>(kBins);
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int before = __popc(peers & ((1u << lane) - 1u));
  if (valid && lane == __ffs(peers) - 1) wcount[warp * kBins + d] = __popc(peers);
  __syncthreads();
  int pos = -1;
  if (valid) {
    pos = run[d] + before;
    for (int w = 0; w < warp; ++w) pos += wcount[w * kBins + d];
  }
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < kWarps; ++w) {
    tot += wcount[w * kBins + threadIdx.x];
    wcount[w * kBins + threadIdx.x] = 0;
  }
  run[threadIdx.x] += tot;
  __syncthreads();
  return pos;
}

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
  __shared__ uint32_t keys[2][kSmall];
  __shared__ int32_t idxs[2][kSmall];
  __shared__ int run[kBins];
  __shared__ int wcount[kWarps * kBins];
  uint32_t lives = 0;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    if (keys_in != nullptr) {
      keys[0][i] = keys_in[i];
      idxs[0][i] = idx_in[i];
    } else {
      keys[0][i] = key_at(x, mask, i, is_int);
      idxs[0][i] = i;
      if (mask != nullptr) lives += mask[i] != 0;
    }
  }
  for (int w = 0; w < kWarps; ++w) wcount[w * kBins + threadIdx.x] = 0;
  if (live != nullptr) {
    uint32_t total;
    block_exclusive_scan(lives, &total);
    if (threadIdx.x == 0) *live = static_cast<int32_t>(total);
  }
  __syncthreads();
  const int rounds = static_cast<int>((m + kThreads - 1) / kThreads);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass, src = pass & 1, dst = src ^ 1;
    run[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads)
      atomicAdd(&run[(keys[src][i] >> shift) & 0xFFu], 1);
    __syncthreads();
    uint32_t total;
    const uint32_t start = block_exclusive_scan(static_cast<uint32_t>(run[threadIdx.x]), &total);
    run[threadIdx.x] = static_cast<int>(start);
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      const int i = r * kThreads + threadIdx.x;
      const bool valid = i < m;
      const uint32_t key = valid ? keys[src][i] : 0u;
      const int pos = round_rank((key >> shift) & 0xFFu, valid, run, wcount);
      if (!valid) continue;
      const int32_t id = idxs[src][i];
      if (pass < 3) {
        keys[dst][pos] = key;
        idxs[dst][pos] = id;
      } else if (pos < k_out) {
        out_idx[pos] = id;
        out_val[pos] = value_at(x, mask, id);
      }
    }
    __syncthreads();
  }
}

// Above kSmall winners: a histogram launch a pass.  Each block counts its
// tile's digits into column b of hist (kBins x tiles, digit-major); the last
// block turns hist into each (digit, tile)'s first destination.
__global__ void topk_hist_kernel(int pass, int64_t m, const uint32_t* __restrict__ keys_in,
                                 const uint32_t* __restrict__ x, bool is_int,
                                 const uint8_t* __restrict__ mask, uint32_t* hist,
                                 uint32_t* state) {
  __shared__ int counts[kBins];
  __shared__ bool last;
  const int shift = 8 * pass;
  const int64_t nt = gridDim.x;
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kTile);
  const int64_t hi = min(m, lo + kTile);
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t d = keys_in != nullptr ? keys_in[i] : key_at(x, mask, i, is_int);
    atomicAdd(&counts[(d >> shift) & 0xFFu], 1);
  }
  __syncthreads();
  hist[threadIdx.x * nt + blockIdx.x] = counts[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&state[kDone], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  uint32_t row = 0;
  for (int64_t b = 0; b < nt; ++b) row += __ldcg(&hist[threadIdx.x * nt + b]);
  uint32_t total;
  uint32_t at = block_exclusive_scan(row, &total);
  for (int64_t b = 0; b < nt; ++b) {
    const uint32_t c = __ldcg(&hist[threadIdx.x * nt + b]);
    hist[threadIdx.x * nt + b] = at;
    at += c;
  }
  if (threadIdx.x == 0) state[kDone] = 0;
}

// The pass's scatter: block b ranks its tile's items stably (in rounds of
// kThreads, in index order) from its digits' first destinations; the last
// pass writes the first k_out indices and their values.
__global__ void topk_scatter_kernel(int pass, int64_t m, int64_t k_out,
                                    const uint32_t* __restrict__ keys_in,
                                    const int32_t* __restrict__ idx_in,
                                    const uint32_t* __restrict__ x, bool is_int,
                                    const uint8_t* __restrict__ mask,
                                    const uint32_t* __restrict__ hist,
                                    uint32_t* __restrict__ keys_out,
                                    int32_t* __restrict__ idx_out,
                                    uint32_t* __restrict__ out_val,
                                    int32_t* __restrict__ out_idx) {
  __shared__ int run[kBins];
  __shared__ int wcount[kWarps * kBins];
  const int shift = 8 * pass;
  run[threadIdx.x] = static_cast<int>(hist[threadIdx.x * static_cast<int64_t>(gridDim.x) +
                                           blockIdx.x]);
  for (int w = 0; w < kWarps; ++w) wcount[w * kBins + threadIdx.x] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kTile);
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = lo + r * kThreads + threadIdx.x;
    const bool valid = i < m;
    uint32_t key = 0;
    int32_t id = 0;
    if (valid) {
      if (keys_in != nullptr) {
        key = keys_in[i];
        id = idx_in[i];
      } else {
        key = key_at(x, mask, i, is_int);
        id = static_cast<int32_t>(i);
      }
    }
    const int pos = round_rank((key >> shift) & 0xFFu, valid, run, wcount);
    if (!valid) continue;
    if (pass < 3) {
      keys_out[pos] = key;
      idx_out[pos] = id;
    } else if (pos < k_out) {
      out_idx[pos] = id;
      out_val[pos] = value_at(x, mask, id);
    }
  }
}

int64_t work_words(int64_t n, int64_t k) {
  return kStateWords + tiles(n) + 4 * k + static_cast<int64_t>(kBins) * tiles(k);
}

}  // namespace

// values (the entries' 32 bits) and indices i32[k] of the k largest of x[n]
// (float32, or int32 with is_int; mask: u8[n] or null, float32 only, a
// clear byte counting as -inf); live (i32[1] or null, with a mask): the
// count of set mask bytes.  work: i32 scratch of at least kStateWords +
// tiles(n) + 4 k + 256 tiles(k) words (tiles(m) = ceil(m / 4096)) above
// kSmall entries, the wrapper's `_top_k_work_words`.
extern "C" int cc_top_k(int64_t n, int64_t k, int64_t is_int, const uint32_t* x,
                        const uint8_t* mask, uint32_t* out_val, int32_t* out_idx, int32_t* live,
                        int32_t* work, int64_t work_size, cudaStream_t stream) {
  if (k <= 0 || k > n || n > 0x7FFFFFFF || (is_int && mask != nullptr))
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
  uint32_t* tile_counts = state + kStateWords;
  uint32_t* keys_a = tile_counts + tiles(n);
  int32_t* idx_a = reinterpret_cast<int32_t*>(keys_a + k);
  uint32_t* keys_b = reinterpret_cast<uint32_t*>(idx_a + k);
  int32_t* idx_b = reinterpret_cast<int32_t*>(keys_b + k);
  uint32_t* hist = reinterpret_cast<uint32_t*>(idx_b + k);
  cudaMemsetAsync(state, 0, sizeof(uint32_t) * kStateWords, stream);
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
  const unsigned grid = static_cast<unsigned>(tiles(k));
  for (int pass = 0; pass < 4; ++pass) {
    uint32_t* keys_out = (pass & 1) ? keys_a : keys_b;
    int32_t* idx_out = (pass & 1) ? idx_a : idx_b;
    topk_hist_kernel<<<grid, kThreads, 0, stream>>>(pass, k, keys_in, x, as_int, mask, hist,
                                                    state);
    topk_scatter_kernel<<<grid, kThreads, 0, stream>>>(pass, k, k, keys_in, idx_in, x, as_int,
                                                       mask, hist, keys_out, idx_out, out_val,
                                                       out_idx);
    keys_in = keys_out;
    idx_in = idx_out;
  }
  return static_cast<int>(cudaGetLastError());
}
