// K13 — masked column statistics of the cluster model.
//
// Replaces the reductions of cruise_control_tpu/model/stats.py:79
// compute_stats (its _masked_stats, :70): per column of an f32[B, C] table
// (broker utilisation per resource, replica and leader counts, potential
// NW_OUT), the mean, max, min and population std-dev over the alive
// brokers.  Output f32[4, C]: rows mean, max, min, std; an empty mask gives
// mean 0, max -inf, min +inf, std 0, as the plain version does.
//
// Bound on the card: bytes (B * (4C + 1) read, 16C written: ~1.5 KB at the
// mid rung), so a launch costs far more than the work; run twice a solve.
//
// Design: one block per column.  A strided pass accumulates count, sum,
// max and min in registers in a fixed order, a fixed shared-memory tree
// combines them, and a second strided pass does the same for the squared
// deviations from the mean.  No atomics: deterministic.  The sums run in
// another order than torch's, so the result agrees with the plain version
// within a relative 1e-6, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void cluster_stats_kernel(const float* __restrict__ values,
                                     const uint8_t* __restrict__ mask, int64_t rows,
                                     int64_t cols, float* __restrict__ out) {
  __shared__ float s_sum[kThreads], s_max[kThreads], s_min[kThreads];
  __shared__ int32_t s_n[kThreads];
  const int64_t c = blockIdx.x;
  const int t = threadIdx.x;
  float sum = 0.f, vmax = -INFINITY, vmin = INFINITY;
  int32_t n = 0;
  for (int64_t r = t; r < rows; r += kThreads) {
    if (!mask[r]) continue;
    const float v = values[r * cols + c];
    sum = __fadd_rn(sum, v);
    vmax = fmaxf(vmax, v);
    vmin = fminf(vmin, v);
    n += 1;
  }
  s_sum[t] = sum;
  s_max[t] = vmax;
  s_min[t] = vmin;
  s_n[t] = n;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      s_sum[t] = __fadd_rn(s_sum[t], s_sum[t + stride]);
      s_max[t] = fmaxf(s_max[t], s_max[t + stride]);
      s_min[t] = fminf(s_min[t], s_min[t + stride]);
      s_n[t] += s_n[t + stride];
    }
    __syncthreads();
  }
  const float count = static_cast<float>(s_n[0] > 0 ? s_n[0] : 1);
  const float mean = __fdiv_rn(s_sum[0], count);
  __syncthreads();
  float ssq = 0.f;
  for (int64_t r = t; r < rows; r += kThreads) {
    if (!mask[r]) continue;
    const float dv = __fsub_rn(values[r * cols + c], mean);
    ssq = __fadd_rn(ssq, __fmul_rn(dv, dv));
  }
  s_sum[t] = ssq;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) s_sum[t] = __fadd_rn(s_sum[t], s_sum[t + stride]);
    __syncthreads();
  }
  if (t == 0) {
    out[c] = mean;
    out[cols + c] = s_max[0];
    out[2 * cols + c] = s_min[0];
    out[3 * cols + c] = sqrtf(__fdiv_rn(s_sum[0], count));
  }
}

}  // namespace

extern "C" int cc_cluster_stats(const float* values, const uint8_t* mask, int64_t rows,
                                int64_t cols, float* out, cudaStream_t stream) {
  if (cols <= 0) return 0;
  cluster_stats_kernel<<<static_cast<unsigned>(cols), kThreads, 0, stream>>>(
      values, mask, rows, cols, out);
  return static_cast<int>(cudaGetLastError());
}
