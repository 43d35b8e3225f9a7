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
// calls it and gets the sum.  ``sh`` holds max(32, ceil(n / 32)) floats,
// ``out`` one: the first level runs one window per thread, the rest in
// thread 0.
template <class V>
__device__ float block_sum(const V& v, int64_t n, float* sh, float* out) {
  const int t = threadIdx.x;
  int64_t count = n;
  if (n > kWindow) {
    const int64_t w = (n + kWindow - 1) / kWindow, lo = (w * kWindow - n) / 2;
    for (int64_t k = t; k < w; k += blockDim.x) {
      float acc = 0.f;
      for (int64_t i = k * kWindow - lo; i < k * kWindow - lo + kWindow; ++i)
        if (i >= 0 && i < n) acc = __fadd_rn(acc, v(i));
      sh[k] = acc;
    }
    count = w;
  } else {
    for (int64_t k = t; k < n; k += blockDim.x) sh[k] = v(k);
  }
  __syncthreads();
  if (t == 0) {
    while (count > kWindow) {
      const int64_t w = (count + kWindow - 1) / kWindow, lo = (w * kWindow - count) / 2;
      for (int64_t k = 0; k < w; ++k) {  // in place: window k reads only indices >= k
        float acc = 0.f;
        for (int64_t i = k * kWindow - lo; i < k * kWindow - lo + kWindow; ++i)
          if (i >= 0 && i < count) acc = __fadd_rn(acc, sh[i]);
        sh[k] = acc;
      }
      count = w;
    }
    float acc = 0.f;
    for (int64_t i = 0; i < count; ++i) acc = __fadd_rn(acc, sh[i]);
    out[0] = acc;
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

// The inclusive ordered cumsum of a[0..n) in place, by the calling thread
// alone; ``scratch`` holds n / 15 + 16 floats for the levels above.
__device__ inline void serial_cumsum(float* a, int64_t n, float* scratch) {
  float* level[kMaxLevels];
  int64_t size[kMaxLevels];
  int depth = 0;
  level[0] = a;
  size[0] = n;
  float* next = scratch;
  while (true) {
    const int64_t m = size[depth], blocks = (m + kBlock - 1) / kBlock;
    for (int64_t b = 0; b < blocks; ++b) scan_block(level[depth], m, 1, b, 0);
    if (m <= kBlock || depth == kMaxLevels - 1) break;
    for (int64_t b = 0; b < blocks; ++b) next[b] = block_total(level[depth], m, 1, b, 0);
    level[++depth] = next;
    size[depth] = blocks;
    next += blocks;
  }
  for (int d = depth - 1; d >= 0; --d)
    for (int64_t i = kBlock; i < size[d]; ++i) add_back(level[d], i, 1, 0, level[d + 1]);
}

}  // namespace ordered
