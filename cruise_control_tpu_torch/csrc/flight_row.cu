// K8's flight rows — the solve flight recorder's per-step telemetry row,
// written by the gated step (and so recorded inside its CUDA graph).
//
// cc_flight_row replaces the recorder extras of
// cruise_control_tpu/analyzer/optimizer.py:1213-1237 (_goal_step with
// ``flight``) and the row write of _goal_fixpoint_budget (:1638-1649): for
// one step over its K candidates, in one block,
//   - the kept count of each candidate batch (move, leadership, intra move,
//     swap, intra swap as the step built them: ``offsets`` i32[nseg + 1]
//     cuts the K axis, ``kinds`` i32[nseg] names each batch's FLIGHT_KINDS
//     index), their sum (the step's actions) and the kind of the batch
//     that kept the most (the first such batch; -1 when nothing was kept);
//   - the largest ``score`` over ``eligible`` lanes (-inf when none), its
//     f32 bits kept as an i32;
//   - for band kinds the population of the K9 frontier mask of the step's
//     entry model (``fmask`` bool[B]; null: -1);
// and writes the i32[7] row [actions, frontier, repair, bisect depth, lanes
// live, score bits, kind] at row min(steps, cap - 1) of ``buf`` (i32[cap,
// 7]), with ``steps`` the chunk's step counter before this step.  It reads
// the step's gate from the counters (last_n > 0 and steps < budget) and
// writes nothing when the step is gated off: the JAX package's while loop
// never runs such a step, while a replayed graph does.
//
// Integer sums (block atomics on shared ints) and a float maximum are exact
// in any order, so the row equals the plain version's bit for bit.
//
// Bound: bytes — K bytes of keep, 5 K of score and eligible, B of the
// frontier mask and 28 B written: about 0.5 MB at K = 100,000.  One block
// of 1,024 threads: at the step's K the kernel is launch-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// state.py CTR_* slots and FLIGHT_WIDTH.
constexpr int kSteps = 0, kLastN = 2, kBudget = 6;
constexpr int kWidth = 7;
constexpr int kMaxSegments = 8;
constexpr int kThreads = 1024;

__global__ void flight_row_kernel(const int32_t* __restrict__ counters,
                                  const uint8_t* __restrict__ keep, int64_t k,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ kinds, int nseg,
                                  const float* __restrict__ score,
                                  const uint8_t* __restrict__ eligible,
                                  const uint8_t* __restrict__ fmask, int64_t b,
                                  const int32_t* __restrict__ rep,
                                  const int32_t* __restrict__ lanes, int32_t depth,
                                  int32_t* __restrict__ buf, int64_t cap) {
  const int32_t steps = counters[kSteps];
  if (!(counters[kLastN] > 0 && steps < counters[kBudget])) return;  // gated off
  __shared__ int seg_count[kMaxSegments];
  __shared__ int front;
  __shared__ float best[kThreads];
  if (threadIdx.x < kMaxSegments) seg_count[threadIdx.x] = 0;
  if (threadIdx.x == 0) front = 0;
  __syncthreads();
  int mine[kMaxSegments];
  for (int s = 0; s < kMaxSegments; ++s) mine[s] = 0;
  float m = -INFINITY;
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    if (keep[i]) {
      int s = 0;
      while (s + 1 < nseg && i >= offsets[s + 1]) ++s;
      ++mine[s];
    }
    if (eligible[i]) {
      const float v = score[i];
      if (v > m) m = v;
    }
  }
  for (int s = 0; s < nseg; ++s)
    if (mine[s]) atomicAdd(&seg_count[s], mine[s]);
  if (fmask != nullptr) {
    int f = 0;
    for (int64_t i = threadIdx.x; i < b; i += blockDim.x) f += fmask[i] ? 1 : 0;
    if (f) atomicAdd(&front, f);
  }
  best[threadIdx.x] = m;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const float o = best[threadIdx.x + stride];
      if (o > best[threadIdx.x]) best[threadIdx.x] = o;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int32_t n = 0, top = 0;
  for (int s = 0; s < nseg; ++s) {
    n += seg_count[s];
    if (seg_count[s] > seg_count[top]) top = s;
  }
  int32_t row[kWidth];
  row[0] = n;
  row[1] = fmask != nullptr ? front : -1;
  row[2] = rep[0];
  row[3] = depth;
  row[4] = lanes[0];
  row[5] = __float_as_int(best[0]);
  row[6] = n > 0 ? kinds[top] : -1;
  const int64_t at = steps < cap - 1 ? steps : cap - 1;
  for (int j = 0; j < kWidth; ++j) buf[at * kWidth + j] = row[j];
}

}  // namespace

extern "C" int cc_flight_row(const int32_t* counters, const uint8_t* keep, int64_t k,
                             const int32_t* offsets, const int32_t* kinds, int64_t nseg,
                             const float* score, const uint8_t* eligible,
                             const uint8_t* fmask, int64_t b, const int32_t* rep,
                             const int32_t* lanes, int64_t depth, int32_t* buf,
                             int64_t cap, cudaStream_t stream) {
  if (!counters || !keep || !offsets || !kinds || !score || !eligible || !rep || !lanes ||
      !buf || k < 0 || nseg < 1 || nseg > kMaxSegments || b < 0 || cap < 1 ||
      depth < INT32_MIN || depth > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flight_row_kernel<<<1, kThreads, 0, stream>>>(counters, keep, k, offsets, kinds,
                                                static_cast<int>(nseg), score, eligible,
                                                fmask, b, rep, lanes,
                                                static_cast<int32_t>(depth), buf, cap);
  return static_cast<int>(cudaGetLastError());
}
