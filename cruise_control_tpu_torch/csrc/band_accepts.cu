// accepts_band_batch — the AND of the band goals' acceptance over the
// previous goals of a step, as the ``_DBG_NO_BUDGETS`` ablation runs it.
//
// cc_band_accepts replaces cruise_control_tpu/analyzer/goals/kernels.py:931
// ``accepts_band_batch`` (the S band specs' ``accepts`` stacked, :966-975):
// one thread per candidate walks the S specs and ANDs, for each,
//   dest_ok      = metric[dest] + d_dest <= upper[dest]  or  d_dest <= 0
//   src_cap_ok   = metric[src] + d_src <= upper[src]     or  d_src <= 0
//   src_ok       = metric[src] + d_src >= lower[src]     or  d_src >= 0
//                  or the source broker is dead
//   dest_low_ok  = metric[dest] + d_dest >= lower[dest]  or  d_dest >= 0
// as dest_ok and src_cap_ok and (cap_style or (src_ok and dest_low_ok)),
// with ``cap_style`` true for hard goals and the potential-nw-out and
// leader-bytes-in kinds.  Inputs: ``metric``, ``lower``, ``upper`` f32[S, B],
// ``d_src``, ``d_dest`` f32[S, K], ``cap_style`` bool[S], ``alive`` bool[B],
// the candidates' ``src`` and ``dest`` i32[K] (clamped into [0, B - 1], as
// XLA clamps a gather).  ``metric + delta`` is one separately rounded f32
// add (__fadd_rn, never contracted), so the mask equals the plain version's
// bit for bit.
//
// Bound: bytes — 8 S bytes of deltas and 8 of endpoints per candidate, the
// [S, B] tables (read through the cache), one byte written: about 2.4 MB at
// K = 32,768 and S = 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clip(int32_t v, int64_t b) {
  return v < 0 ? 0 : (v >= b ? b - 1 : v);
}

__global__ void band_accepts_kernel(int64_t s, int64_t b, int64_t k,
                                    const float* __restrict__ metric,
                                    const float* __restrict__ lower,
                                    const float* __restrict__ upper,
                                    const float* __restrict__ d_src,
                                    const float* __restrict__ d_dest,
                                    const uint8_t* __restrict__ cap_style,
                                    const uint8_t* __restrict__ alive,
                                    const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dest,
                                    uint8_t* __restrict__ out) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < k;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t sb = clip(src[i], b), db = clip(dest[i], b);
    const bool src_dead = !alive[sb];
    bool ok = true;
    for (int64_t j = 0; j < s && ok; ++j) {
      const float ds = d_src[j * k + i], dd = d_dest[j * k + i];
      const float dest_after = __fadd_rn(metric[j * b + db], dd);
      const float src_after = __fadd_rn(metric[j * b + sb], ds);
      const bool dest_ok = dest_after <= upper[j * b + db] || dd <= 0.0f;
      const bool src_cap_ok = src_after <= upper[j * b + sb] || ds <= 0.0f;
      const bool src_ok = src_after >= lower[j * b + sb] || ds >= 0.0f || src_dead;
      const bool dest_low_ok = dest_after >= lower[j * b + db] || dd >= 0.0f;
      ok = dest_ok && src_cap_ok && (cap_style[j] || (src_ok && dest_low_ok));
    }
    out[i] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int cc_band_accepts(int64_t s, int64_t b, int64_t k, const float* metric,
                               const float* lower, const float* upper, const float* d_src,
                               const float* d_dest, const uint8_t* cap_style,
                               const uint8_t* alive, const int32_t* src,
                               const int32_t* dest, uint8_t* out, cudaStream_t stream) {
  if (s < 1 || b < 1 || k < 0 || !metric || !lower || !upper || !d_src || !d_dest ||
      !cap_style || !alive || !src || !dest || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (k + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  band_accepts_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      s, b, k, metric, lower, upper, d_src, d_dest, cap_style, alive, src, dest, out);
  return static_cast<int>(cudaGetLastError());
}
