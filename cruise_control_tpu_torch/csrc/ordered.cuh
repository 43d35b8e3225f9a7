// The float orders of ops/order.py on the card: XLA's CPU reduction and
// scan orders, built from round-to-nearest adds only, so the card and the
// CPU hold the same bits.
//
// ordered sum: a reduction over more than 32 elements runs as windows of 32
// over the input padded with zeros to a multiple of 32 (the padding split
// evenly before and after, the odd element after), each window summed in
// order from 0, and the same again on the window sums, down to one ordered
// sum of at most 32.
//
// ordered cumsum: a scan of more than 16 rows runs as blocks of 16 rows,
// each scanned in order, plus the scan of the block totals (taken the same
// way) shifted by one block.
//
// Included by ordered.cu (ops/order.py's ordered sum), prefix_cut.cu
// (K3's running totals), stack_sweep.cu and frontier_active.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ordered {

constexpr int64_t kWindow = 32;
constexpr int64_t kBlock = 16;
// Levels of the scan: 16^12 rows is far beyond any shape of the port.
constexpr int kMaxLevels = 12;

// Sum of v(0..n-1) in the ordered-sum order.  Every thread of the block
// (at least one warp) calls it and gets the sum.  ``sh`` holds max(32,
// ceil(n / 32)) floats, ``out`` one: the first level runs one window per
// thread (its 32 loads in flight at once), the levels above one window per
// lane of warp 0, and the last sum of at most 32 runs down warp 0's lanes
// in order.
template <class V>
__device__ float block_sum(const V& v, int64_t n, float* sh, float* out) {
  const int t = threadIdx.x;
  int64_t count = n;
  if (n > kWindow) {
    const int64_t w = (n + kWindow - 1) / kWindow, lo = (w * kWindow - n) / 2;
    for (int64_t k = t; k < w; k += blockDim.x) {
      // The window's loads all issued before its adds (a padding zero
      // added to a sum started at +0 changes no bit).
      float x[kWindow];
#pragma unroll
      for (int q = 0; q < kWindow; ++q) {
        const int64_t i = k * kWindow - lo + q;
        x[q] = i >= 0 && i < n ? v(i) : 0.f;
      }
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kWindow; ++q) acc = __fadd_rn(acc, x[q]);
      sh[k] = acc;
    }
    count = w;
  } else {
    for (int64_t k = t; k < n; k += blockDim.x) sh[k] = v(k);
  }
  __syncthreads();
  if (t < 32) {
    while (count > kWindow) {
      const int64_t w = (count + kWindow - 1) / kWindow, lo = (w * kWindow - count) / 2;
      // In place: the windows of lanes base.. read only indices >= base * 32 - lo.
      for (int64_t base = 0; base < w; base += 32) {
        const int64_t k = base + t;
        float acc = 0.f;
        if (k < w)
          for (int64_t i = k * kWindow - lo; i < k * kWindow - lo + kWindow; ++i)
            if (i >= 0 && i < count) acc = __fadd_rn(acc, sh[i]);
        __syncwarp();
        if (k < w) sh[k] = acc;
        __syncwarp();
      }
      count = w;
    }
    const float x = t < count ? sh[t] : 0.f;
    float acc = 0.f;
    for (int64_t i = 0; i < count; ++i)
      acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, x, static_cast<int>(i)));
    if (t == 0) out[0] = acc;
  }
  __syncthreads();
  const float r = out[0];
  __syncthreads();
  return r;
}

// x[i] of a plain array, for block_sum.
struct Array {
  const float* x;
  __device__ float operator()(int64_t i) const { return x[i]; }
};

// The scan's three steps on column ``ch`` of f32[n, c] (row-major), one
// block of 16 rows at a time.  A level scans its blocks, gathers their
// totals into the next level, and after the next level is scanned adds the
// total of the block before to every row of the blocks after the first.

// Scan of the rows of block ``b``, in place, in row order.
__device__ __forceinline__ void scan_block(float* x, int64_t n, int64_t c, int64_t b,
                                           int64_t ch) {
  float acc = x[kBlock * b * c + ch];
  for (int64_t j = 1; j < kBlock && kBlock * b + j < n; ++j) {
    const int64_t i = (kBlock * b + j) * c + ch;
    acc = __fadd_rn(x[i], acc);
    x[i] = acc;
  }
}

// The total of block ``b`` after its scan (its last row).
__device__ __forceinline__ float block_total(const float* x, int64_t n, int64_t c,
                                             int64_t b, int64_t ch) {
  const int64_t last = kBlock * b + kBlock - 1 < n ? kBlock * b + kBlock - 1 : n - 1;
  return x[last * c + ch];
}

// Row ``i`` (of block 1 or later) adds the scanned total of the block
// before it; ``scanned`` is the next level, f32[blocks, c].
__device__ __forceinline__ void add_back(float* x, int64_t i, int64_t c, int64_t ch,
                                         const float* scanned) {
  if (i >= kBlock)
    x[i * c + ch] = __fadd_rn(x[i * c + ch], scanned[(i / kBlock - 1) * c + ch]);
}

// Floats of the levels of a scan of n values kept in place: n, then one level
// per 16x until a level of at most 16.
__host__ __device__ inline int64_t level_floats(int64_t n) {
  int64_t floats = 0;
  for (int64_t m = n;; m = (m + kBlock - 1) / kBlock) {
    floats += m;
    if (m <= kBlock) return floats;
  }
}

// The inclusive ordered cumsum of x[0..n) in place, by the 32 lanes of the
// calling warp (every lane calls it); the levels above go to x + n ...
// (level_floats(n) floats in all).  A lane scans one block of 16 of a level
// at a time.
__device__ inline void warp_cumsum(float* x, int64_t n) {
  const int lane = threadIdx.x & 31;
  float* level[kMaxLevels];
  int64_t size[kMaxLevels];
  int depth = 0;
  level[0] = x;
  size[0] = n;
  float* next = x + n;
  while (true) {
    const int64_t m = size[depth], blocks = (m + kBlock - 1) / kBlock;
    for (int64_t b = lane; b < blocks; b += 32) scan_block(level[depth], m, 1, b, 0);
    __syncwarp();
    if (m <= kBlock || depth == kMaxLevels - 1) break;
    for (int64_t b = lane; b < blocks; b += 32) next[b] = block_total(level[depth], m, 1, b, 0);
    __syncwarp();
    level[depth + 1] = next;
    size[depth + 1] = blocks;
    next += blocks;
    ++depth;
  }
  for (int d = depth - 1; d >= 0; --d) {
    for (int64_t i = kBlock + lane; i < size[d]; i += 32) add_back(level[d], i, 1, 0, level[d + 1]);
    __syncwarp();
  }
}

}  // namespace ordered
