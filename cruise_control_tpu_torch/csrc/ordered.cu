// The ordered sum of ops/order.py on the card: f32[n, c] summed along the
// rows in the order of ordered.cuh (windows of 32, padded with zeros split
// before and after, each summed in order from 0, and again on the window
// sums down to one value).
//
// cc_ordered_sum replaces the alive-broker sums of the band goals'
// averages: cruise_control_tpu/analyzer/goals/kernels.py:190 (limits) and
// analyzer/optimizer.py:311 (_band_sides), each a ``jnp.sum`` over B
// brokers, one column or four.  Bound on the card: bytes (n * c * 4 read,
// c * 4 written: 16 KB at 1,000 brokers and four columns, about 5 ns at
// 3.35 TB/s), so the launch and the chain of 32 dependent adds are the cost.
//
// Design: one launch for all columns, one warp per column, no block-wide
// synchronisation (the launch and the chains of dependent adds are the
// cost; the bytes are a few KB, read from L1 after the first touch).  Lane
// k of a warp sums window k of the padded column (windows k + 32, k + 64,
// ... past 32 windows): it issues the window's 32 predicated loads at once
// and then adds them in order from 0, padding zeros included, as the plain
// version does.  The window sums go to the warp's shared memory; lane k
// sums window k of the next level (at most 16 of them for 16,384 rows) and
// one lane adds those in order.  The plain version's adds in its order (a
// sum started at +0 is never -0, so adding or skipping padding zeros
// changes no bit), so the card, the CPU and the JAX package's compiled CPU
// sum agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr int kWarps = 8;                           // columns a block
constexpr int kMaxWindows = 512;                    // 16,384 rows
constexpr int kWindow = static_cast<int>(ordered::kWindow);
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ int windows(int64_t count) {
  return count > 0 ? static_cast<int>((count + kWindow - 1) / kWindow) : 1;
}

__global__ void ordered_sum_kernel(const float* __restrict__ x, int n, int64_t c,
                                   float* __restrict__ out) {
  __shared__ float sums[kWarps][kMaxWindows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (j >= c) return;  // the whole warp
  const int w = windows(n), lo = (w * kWindow - n) / 2;
  for (int k = lane; k < w; k += 32) {
    float v[kWindow];
#pragma unroll
    for (int q = 0; q < kWindow; ++q) {
      const int r = k * kWindow - lo + q;
      v[q] = r >= 0 && r < n ? x[static_cast<int64_t>(r) * c + j] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kWindow; ++q) acc = __fadd_rn(acc, v[q]);
    sums[warp][k] = acc;
  }
  __syncwarp();
  // The next level: w2 <= 16 windows of the w sums, then their sum in order.
  const int w2 = windows(w), lo2 = (w2 * kWindow - w) / 2;
  float s2 = 0.f;
  if (lane < w2) {
#pragma unroll
    for (int q = 0; q < kWindow; ++q) {
      const int i = lane * kWindow - lo2 + q;
      if (i >= 0 && i < w) s2 = __fadd_rn(s2, sums[warp][i]);
    }
  }
  float total = 0.f;
  for (int k = 0; k < w2; ++k) total = __fadd_rn(total, __shfl_sync(kFull, s2, k));
  if (lane == 0) out[j] = total;
}

}  // namespace

// out[j] = ordered sum of x[:, j], j < c; x is f32[n, c] row-major.
// n <= 32 * 512.
extern "C" int cc_ordered_sum(const float* x, float* out, int64_t n, int64_t c,
                              cudaStream_t stream) {
  if (c <= 0) return 0;
  if (n < 0 || n > kWindow * kMaxWindows) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (c + kWarps - 1) / kWarps;
  const int64_t warps = c < kWarps ? c : kWarps;
  ordered_sum_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * warps), 0,
                       stream>>>(x, static_cast<int>(n), c, out);
  return static_cast<int>(cudaGetLastError());
}
