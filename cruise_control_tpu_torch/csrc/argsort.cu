// K6 argsort — the stable ascending argsorts of the matched builders and of
// K3 (cc_argsort, cc_row_argsort).
//
// Replaces the jnp.argsort(..., stable=True) calls of the JAX package's main
// path: the matched builders' (cruise_control_tpu/analyzer/candidates.py:177
// by broker, :297 by (topic, broker) pair, :319 by topic before each
// transport rank; :280, :330, :331 the donors', deficits' and spares' [T, B]
// row orders) and K3's score and regroup sorts (cruise_control_tpu/analyzer/
// goals/kernels.py:1006-1007 _sorted_prefix_tables).  The wrappers and the
// plain twin: ops/order.py argsort, argsort_into and argsort_plain.
//
// Result, exactly as the plain twin (torch's stable sort of the canonical
// key): the indices that sort the key ascending, ties in index order, as
// int64 (and, where asked, int32 indices and the sorted keys).  Each key
// becomes a uint32 whose ascending order is the sort's:
//   - float32: -0.0 equals +0.0; every NaN, whatever its sign bit, after
//     every number (the sites sort -score, which flips a NaN's sign bit);
//     the rest by the IEEE order (sign set: ~bits, else bits | 2^31);
//   - int32 with no declared range: the sign bit flipped;
//   - int32 keys declared in [0, num_keys): the key itself, and the LSD
//     radix runs only ceil(bits(num_keys - 1) / 8) passes of 8 bits (the
//     wrapper checks the range on CPU tensors; a key outside would mis-sort).
//
// Design: the stable LSD radix stage of radix.cuh, shared with cc_top_k.
//   - Up to kSmall (2,048) entries, one block sorts the whole input in
//     shared memory: one launch.
//   - Above, the one-sweep sort of radix.cuh: one memset of its counters a
//     call, one histogram launch for every pass, then one launch a pass
//     over tiles of 1,024 items that rank their items stably by warp
//     matching from destinations found by a decoupled look-back.
//   - cc_row_argsort: one block a row of an int32 [T, B] array (B <= kSmall),
//     four passes, one launch for all rows.
// Every launch runs on the given stream, allocates nothing (the wrapper
// sizes the scratch from n) and reads nothing back: every call can be
// captured into the step graphs.
//
// Bound on the card: bytes — the key read once and the int64 indices
// written once (12 bytes an entry).  The passes re-read their items from L2
// at the main path's sizes (n <= 262,144), so a call is launch-bound: one
// launch up to kSmall entries, else a memset, a histogram launch and one
// launch a pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

using radix::kSmall;
using radix::kThreads;

enum KeyKind { kFloat = 0, kInt = 1, kRanged = 2 };

// The uint32 whose ascending order is the key's (see the header).
__device__ __forceinline__ uint32_t sort_key(uint32_t b, int kind) {
  if (kind == kRanged) return b;
  if (kind == kInt) return b ^ 0x80000000u;
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // NaN, either sign
  if (b == 0x80000000u) b = 0u;                              // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// A pass's items: from the previous pass (keys_in non-null) or straight from
// the input (key of entry i, id i).
struct ArgLoad {
  const uint32_t* keys_in;
  const int32_t* ids_in;
  const uint32_t* x;
  int kind;
  __device__ uint32_t key(int64_t i) const {
    return keys_in != nullptr ? keys_in[i] : sort_key(x[i], kind);
  }
  __device__ int32_t id(int64_t i) const {
    return keys_in != nullptr ? ids_in[i] : static_cast<int32_t>(i);
  }
};

// Into (keys_out, ids_out) between passes; after the last pass, the
// index as int64 and / or int32 and, where asked, the sorted key (the
// input's own bits for a declared-range key).
struct ArgStore {
  bool last;
  uint32_t* keys_out;
  int32_t* ids_out;
  int64_t* out_idx;
  int32_t* out_idx32;
  uint32_t* out_keys;
  __device__ void operator()(int64_t pos, uint32_t key, int32_t id) const {
    if (!last) {
      keys_out[pos] = key;
      ids_out[pos] = id;
      return;
    }
    if (out_idx != nullptr) out_idx[pos] = id;
    if (out_idx32 != nullptr) out_idx32[pos] = id;
    if (out_keys != nullptr) out_keys[pos] = key;
  }
};

__global__ void argsort_block_kernel(int n, int passes, const uint32_t* __restrict__ x,
                                     int kind, int64_t* __restrict__ out_idx,
                                     int32_t* __restrict__ out_idx32,
                                     uint32_t* __restrict__ out_keys) {
  radix::block_sort(n, passes, ArgLoad{nullptr, nullptr, x, kind},
                    ArgStore{true, nullptr, nullptr, out_idx, out_idx32, out_keys});
}

// The one-sweep (radix.cuh) over tiles of 1,024 items, so that the main
// path's sizes (n = 65,536 to 250,863) spread over 64 to 245 blocks of the
// card's 132 SMs.
__global__ void argsort_hist_kernel(int64_t n, int passes, const uint32_t* __restrict__ x,
                                    int kind, uint32_t* __restrict__ sweep) {
  radix::sweep_hist(n, passes, ArgLoad{nullptr, nullptr, x, kind}, sweep);
}

__global__ void argsort_scatter_kernel(int pass, int64_t n, bool last,
                                       const uint32_t* __restrict__ keys_in,
                                       const int32_t* __restrict__ ids_in,
                                       const uint32_t* __restrict__ x, int kind,
                                       uint32_t* sweep, uint32_t* __restrict__ keys_out,
                                       int32_t* __restrict__ ids_out,
                                       int64_t* __restrict__ out_idx,
                                       int32_t* __restrict__ out_idx32,
                                       uint32_t* __restrict__ out_keys) {
  radix::sweep_pass(pass, n, ArgLoad{keys_in, ids_in, x, kind}, sweep,
                    ArgStore{last, keys_out, ids_out, out_idx, out_idx32, out_keys});
}

// One block a row: the row's int32 keys (no declared range), its column
// indices as int64.
__global__ void row_sort_kernel(int width, const uint32_t* __restrict__ x,
                                int64_t* __restrict__ out) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * width;
  radix::block_sort(width, 4, ArgLoad{nullptr, nullptr, x + at, kInt},
                    ArgStore{true, nullptr, nullptr, out + at, nullptr, nullptr});
}

// The scratch, in words: the sweep's (radix::sweep_words: the passes' tile
// counters, digit counts and look-back status), then two buffers of keys
// and ids.  A call zeroes the sweep's words for its passes with one memset.
int64_t work_words(int64_t n) { return radix::sweep_words(n) + 4 * n; }

}  // namespace

// The stable ascending argsort of x[n] (32-bit keys of `kind`: 0 float32,
// 1 int32, 2 int32 in [0, 2^(8 passes))) in `passes` 8-bit passes (1..4;
// 4 unless kind is 2): indices into out_idx (int64) and / or out_idx32
// (int32), the sorted keys into out_keys (kind 2: the keys themselves);
// any of the three may be null; n < 2^30.  work: i32 scratch of at least
// 1,032 + 1,024 tiles(n) + 4 n words (tiles(n) = ceil(n / 1024)) above 2,048
// entries, the wrapper's `argsort_work_words`.
extern "C" int cc_argsort(int64_t n, int64_t passes, int64_t kind, const uint32_t* x,
                          int64_t* out_idx, int32_t* out_idx32, uint32_t* out_keys, int32_t* work,
                          int64_t work_size, cudaStream_t stream) {
  if (n < 0 || n > radix::kSweepMax || passes < 1 || passes > 4 || kind < kFloat ||
      kind > kRanged || (kind != kRanged && passes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int k = static_cast<int>(kind);
  if (n <= kSmall) {
    argsort_block_kernel<<<1, kThreads, 0, stream>>>(static_cast<int>(n),
                                                      static_cast<int>(passes), x, k, out_idx,
                                                      out_idx32, out_keys);
    return static_cast<int>(cudaGetLastError());
  }
  if (work == nullptr || work_size < work_words(n)) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* sweep = reinterpret_cast<uint32_t*>(work);
  uint32_t* keys_a = sweep + radix::sweep_words(n);
  int32_t* ids_a = reinterpret_cast<int32_t*>(keys_a + n);
  uint32_t* keys_b = reinterpret_cast<uint32_t*>(ids_a + n);
  int32_t* ids_b = reinterpret_cast<int32_t*>(keys_b + n);
  cudaMemsetAsync(sweep, 0, sizeof(uint32_t) * radix::sweep_words(n, static_cast<int>(passes)),
                  stream);
  const unsigned grid = static_cast<unsigned>(radix::sweep_tiles(n));
  argsort_hist_kernel<<<grid, kThreads, 0, stream>>>(n, static_cast<int>(passes), x, k, sweep);
  const uint32_t* keys_in = nullptr;  // the first pass reads the input
  const int32_t* ids_in = nullptr;
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    uint32_t* keys_out = (pass & 1) ? keys_a : keys_b;
    int32_t* ids_out = (pass & 1) ? ids_a : ids_b;
    argsort_scatter_kernel<<<grid, kThreads, 0, stream>>>(
        pass, n, last, keys_in, ids_in, x, k, sweep, keys_out, ids_out, out_idx, out_idx32,
        out_keys);
    keys_in = keys_out;
    ids_in = ids_out;
  }
  return static_cast<int>(cudaGetLastError());
}

// The stable ascending argsort of each row of the int32 array x[rows, width]
// (width <= 2,048): the column indices as int64 into out[rows, width].
extern "C" int cc_row_argsort(int64_t rows, int64_t width, const uint32_t* x, int64_t* out,
                              cudaStream_t stream) {
  if (rows < 0 || rows > INT_MAX || width < 0 || width > kSmall)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || width == 0) return 0;
  row_sort_kernel<<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<int>(width), x, out);
  return static_cast<int>(cudaGetLastError());
}
