// The ordered sum and the ordered cumsum of ops/order.py on the card, on
// f32[n, c] along the rows, in the orders of ordered.cuh.
//
// cc_ordered_sum replaces the alive-broker sums of the band goals'
// averages: cruise_control_tpu/analyzer/goals/kernels.py:190 (limits) and
// analyzer/optimizer.py:311 (_band_sides), each a ``jnp.sum`` over B
// brokers.  Bound on the card: bytes (n * c * 4 read, c * 4 written: a few
// KB at 1000 brokers), so the launch is the cost.  Design: one block per
// column, ordered::block_sum.
//
// cc_ordered_cumsum is K3's running totals (the ``jnp.cumsum`` of
// goals/kernels.py:1011); ops/order.py ordered_cumsum is its plain twin.
// Design: one launch per level of the scan over one thread per (block of
// 16 rows, column), a launch that gathers the block totals into the next
// level, and one add-back launch per level on the way down.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 512;

// Column ``col`` of f32[n, c].
struct Column {
  const float* x;
  int64_t c, col;
  __device__ float operator()(int64_t i) const { return x[i * c + col]; }
};

__global__ void ordered_sum_kernel(const float* __restrict__ x, int64_t n, int64_t c,
                                   float* __restrict__ out) {
  __shared__ float sh[kSumThreads];
  __shared__ float res[1];
  const float s = ordered::block_sum(Column{x, c, blockIdx.x}, n, sh, res);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

__global__ void scan_blocks_kernel(float* __restrict__ x, int64_t n, int64_t c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (n + ordered::kBlock - 1) / ordered::kBlock * c) return;
  ordered::scan_block(x, n, c, t / c, t % c);
}

__global__ void block_totals_kernel(const float* __restrict__ x, int64_t n, int64_t c,
                                    float* __restrict__ totals) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (n + ordered::kBlock - 1) / ordered::kBlock * c) return;
  totals[t] = ordered::block_total(x, n, c, t / c, t % c);
}

__global__ void add_back_kernel(float* __restrict__ x, int64_t n, int64_t c,
                                const float* __restrict__ scanned) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * c) return;
  ordered::add_back(x, t / c, c, t % c, scanned);
}

unsigned grid_of(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// out[j] = ordered sum of x[:, j], j < c.  n <= 32 * 512.
extern "C" int cc_ordered_sum(const float* x, float* out, int64_t n, int64_t c,
                              cudaStream_t stream) {
  if (c <= 0) return 0;
  if (n < 0 || n > ordered::kWindow * kSumThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  ordered_sum_kernel<<<static_cast<unsigned>(c), kSumThreads, 0, stream>>>(x, n, c, out);
  return static_cast<int>(cudaGetLastError());
}

// The ordered cumsum of f32[n, c] along the rows, in place; ``scratch``
// holds (n / 15 + 16) * c floats for the block totals of every level.
extern "C" int cc_ordered_cumsum(float* x, float* scratch, int64_t n, int64_t c,
                                 cudaStream_t stream) {
  if (n <= 0 || c <= 0) return 0;
  float* level[ordered::kMaxLevels];
  int64_t size[ordered::kMaxLevels];
  int depth = 0;
  level[0] = x;
  size[0] = n;
  float* next = scratch;
  while (true) {
    const int64_t blocks = (size[depth] + ordered::kBlock - 1) / ordered::kBlock;
    scan_blocks_kernel<<<grid_of(blocks * c), kThreads, 0, stream>>>(level[depth],
                                                                    size[depth], c);
    if (size[depth] <= ordered::kBlock || depth == ordered::kMaxLevels - 1) break;
    block_totals_kernel<<<grid_of(blocks * c), kThreads, 0, stream>>>(level[depth],
                                                                     size[depth], c, next);
    level[depth + 1] = next;
    size[depth + 1] = blocks;
    next += blocks * c;
    ++depth;
  }
  for (int d = depth - 1; d >= 0; --d)
    add_back_kernel<<<grid_of(size[d] * c), kThreads, 0, stream>>>(level[d], size[d], c,
                                                                   level[d + 1]);
  return static_cast<int>(cudaGetLastError());
}
