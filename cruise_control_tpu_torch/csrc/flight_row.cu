// K8's flight rows — the solve flight recorder's per-step telemetry row,
// written by the gated step (and so recorded inside its CUDA graph).
//
// cc_flight_row replaces the recorder extras of
// cruise_control_tpu/analyzer/optimizer.py:1213-1237 (_goal_step with
// ``flight``) and the row write of _goal_fixpoint_budget (:1638-1649): for
// one step over its K candidates,
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
// 7]), with ``steps`` the chunk's step counter before this step.
//
// Two launches over the grid:
//   flight_partials_kernel: every thread takes groups of 16 lanes, grid-
//     strided, and reads each group's ``keep`` and ``eligible`` as one
//     16-byte load apiece and its scores as four float4 loads (lanes before
//     the first 16-byte-aligned group and after the last full one, or every
//     lane when the three bases are not aligned alike, go one at a time).
//     The batch bounds (at most 8) sit in registers: a group's kept lanes
//     are a 16-bit mask, and each batch's count is the popcount of its
//     range's bits.  The block sums its threads' counts by warp reductions
//     (__reduce_add_sync), takes the eligible maximum by __reduce_max_sync
//     over order-preserving integer keys of the scores, counts ``fmask`` on
//     the blocks that cover B, and writes one partial row (8 counts, the
//     frontier count, the best key) into ``partials`` (i32[blocks, 10]).
//   flight_row_kernel: one warp reduces the partial rows and writes the
//     row.
// Integer sums and a maximum of integer keys are exact in any order, so the
// row does not depend on which block ends first and equals the plain
// version's bit for bit.  The two launches need no counter between them (a
// counter would have to be reset inside the graph, whose pool aliases
// scratch between steps).
//
// Both launches read the step's gate from the counters (last_n > 0 and
// steps < budget) and return at once when it is off: a step graph skips
// them with the rest of the step, but the eager paths run gated-off steps.
//
// Bound: bytes — K bytes of keep, 5 K of score and eligible, B of the
// frontier mask and 28 B written: about 0.6 MB at K = 102,400, 0.18 us at
// the card's memory rate.  Two small launches: launch-bound at the step's K.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// state.py CTR_* slots and FLIGHT_WIDTH.
constexpr int kSteps = 0, kLastN = 2, kBudget = 6;
constexpr int kWidth = 7;
constexpr int kMaxSegments = 8;
// A partial row: the batches' kept counts, the frontier count, the best key.
constexpr int kFront = kMaxSegments, kBest = kMaxSegments + 1, kPart = kMaxSegments + 2;
constexpr int kGroup = 16;     // lanes a thread reads at once
constexpr int kThreads = 128;  // threads of a partials block
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool gate_on(const int32_t* counters) {
  return counters[kLastN] > 0 && counters[kSteps] < counters[kBudget];
}

// An integer key that orders floats as their values (-0 below +0).
__device__ __forceinline__ int32_t order_key(float v) {
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ int32_t key_to_bits(int32_t k) {
  return k >= 0 ? k : k ^ 0x7fffffff;
}

// A batch bound relative to a group's first lane, clipped to [0, kGroup].
__device__ __forceinline__ int clamp_group(int64_t x) {
  return x < 0 ? 0 : (x > kGroup ? kGroup : static_cast<int>(x));
}

// Bit j set where byte j of the 16 is not zero.
__device__ __forceinline__ unsigned byte_bits(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned t = __vcmpne4(w[q], 0u) & 0x01010101u;
    t = (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu;
    m |= t << (4 * q);
  }
  return m;
}

// The first lane of the vector groups: where ``keep`` reaches a 16-byte
// boundary, if ``eligible`` and ``score`` do there too; else k (every lane
// one at a time).
__device__ __forceinline__ int64_t vector_head(const uint8_t* keep, const uint8_t* eligible,
                                               const float* score, int64_t k) {
  const int64_t h = (kGroup - static_cast<int64_t>(reinterpret_cast<uintptr_t>(keep) & 15)) & 15;
  if (h >= k || (reinterpret_cast<uintptr_t>(eligible + h) & 15) ||
      (reinterpret_cast<uintptr_t>(score + h) & 15))
    return k;
  return h;
}

__global__ void __launch_bounds__(kThreads)
flight_partials_kernel(const int32_t* __restrict__ counters, const uint8_t* __restrict__ keep,
                       int64_t k, const int32_t* __restrict__ offsets, int nseg,
                       const float* __restrict__ score, const uint8_t* __restrict__ eligible,
                       const uint8_t* __restrict__ fmask, int64_t b,
                       int32_t* __restrict__ partials) {
  if (!gate_on(counters)) return;
  int64_t lo[kMaxSegments], hi[kMaxSegments];
#pragma unroll
  for (int s = 0; s < kMaxSegments; ++s) {
    lo[s] = s < nseg ? offsets[s] : k;
    hi[s] = s < nseg ? offsets[s + 1] : k;
  }
  int cnt[kMaxSegments];
#pragma unroll
  for (int s = 0; s < kMaxSegments; ++s) cnt[s] = 0;
  int32_t best = order_key(-INFINITY);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  const int64_t head = vector_head(keep, eligible, score, k);
  const int64_t groups = (k - head) / kGroup;
  for (int64_t g = tid; g < groups; g += stride) {
    const int64_t i0 = head + g * kGroup;
    const unsigned kb = byte_bits(*reinterpret_cast<const uint4*>(keep + i0));
    const unsigned eb = byte_bits(*reinterpret_cast<const uint4*>(eligible + i0));
    const float4* sp = reinterpret_cast<const float4*>(score + i0);
    float v[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const float4 f = sp[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if ((eb >> j) & 1u) best = max(best, order_key(v[j]));
    if (kb) {
#pragma unroll
      for (int s = 0; s < kMaxSegments; ++s) {
        const int a = clamp_group(lo[s] - i0), e = clamp_group(hi[s] - i0);
        const unsigned range = ((1u << e) - 1u) & ~((1u << a) - 1u);
        cnt[s] += __popc(kb & range);
      }
    }
  }
  // The lanes outside the groups: the head, then the tail.
  const int64_t tail = head + groups * kGroup;
  const int64_t scalar = head + (k - tail);
  for (int64_t j = tid; j < scalar; j += stride) {
    const int64_t i = j < head ? j : tail + (j - head);
    if (keep[i]) {
#pragma unroll
      for (int s = 0; s < kMaxSegments; ++s) cnt[s] += (i >= lo[s] && i < hi[s]) ? 1 : 0;
    }
    if (eligible[i]) best = max(best, order_key(score[i]));
  }
  int front = 0;
  if (fmask != nullptr)
    for (int64_t i = tid; i < b; i += stride) front += fmask[i] ? 1 : 0;

  __shared__ int32_t red[kThreads / 32][kPart];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kMaxSegments; ++s) {
    const int32_t c = __reduce_add_sync(kFull, cnt[s]);
    if (lane == 0) red[warp][s] = c;
  }
  front = __reduce_add_sync(kFull, front);
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) {
    red[warp][kFront] = front;
    red[warp][kBest] = best;
  }
  __syncthreads();
  if (threadIdx.x < kPart) {
    const int x = threadIdx.x;
    int32_t acc = red[0][x];
    for (int w = 1; w < kThreads / 32; ++w)
      acc = x == kBest ? max(acc, red[w][x]) : acc + red[w][x];
    partials[static_cast<int64_t>(blockIdx.x) * kPart + x] = acc;
  }
}

__global__ void flight_row_kernel(const int32_t* __restrict__ counters,
                                  const int32_t* __restrict__ partials, int blocks,
                                  const int32_t* __restrict__ kinds, int nseg, int has_fmask,
                                  const int32_t* __restrict__ rep,
                                  const int32_t* __restrict__ lanes, int32_t depth,
                                  int32_t* __restrict__ buf, int64_t cap) {
  const int32_t steps = counters[kSteps];
  if (!gate_on(counters)) return;
  const int lane = threadIdx.x;
  int32_t acc[kPart];
#pragma unroll
  for (int x = 0; x < kPart; ++x) acc[x] = x == kBest ? order_key(-INFINITY) : 0;
  for (int p = lane; p < blocks; p += 32) {
#pragma unroll
    for (int x = 0; x < kPart; ++x) {
      const int32_t v = partials[static_cast<int64_t>(p) * kPart + x];
      acc[x] = x == kBest ? max(acc[x], v) : acc[x] + v;
    }
  }
#pragma unroll
  for (int x = 0; x < kPart; ++x)
    acc[x] = x == kBest ? __reduce_max_sync(kFull, acc[x]) : __reduce_add_sync(kFull, acc[x]);
  if (lane != 0) return;
  int32_t n = 0, top = 0, top_count = acc[0];
#pragma unroll
  for (int s = 0; s < kMaxSegments; ++s) {
    if (s >= nseg) break;
    n += acc[s];
    if (acc[s] > top_count) {
      top = s;
      top_count = acc[s];
    }
  }
  int32_t row[kWidth];
  row[0] = n;
  row[1] = has_fmask ? acc[kFront] : -1;
  row[2] = rep[0];
  row[3] = depth;
  row[4] = lanes[0];
  row[5] = key_to_bits(acc[kBest]);
  row[6] = n > 0 ? kinds[top] : -1;
  const int64_t at = steps < cap - 1 ? steps : cap - 1;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) buf[at * kWidth + j] = row[j];
}

}  // namespace

extern "C" int cc_flight_row(const int32_t* counters, const uint8_t* keep, int64_t k,
                             const int32_t* offsets, const int32_t* kinds, int64_t nseg,
                             const float* score, const uint8_t* eligible,
                             const uint8_t* fmask, int64_t b, const int32_t* rep,
                             const int32_t* lanes, int64_t depth, int32_t* buf,
                             int64_t cap, int32_t* partials, int64_t blocks,
                             cudaStream_t stream) {
  if (!counters || !keep || !offsets || !kinds || !score || !eligible || !rep || !lanes ||
      !buf || !partials || k < 0 || nseg < 1 || nseg > kMaxSegments || b < 0 || cap < 1 ||
      blocks < 1 || blocks > kMaxBlocks || depth < INT32_MIN || depth > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flight_partials_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      counters, keep, k, offsets, static_cast<int>(nseg), score, eligible, fmask, b, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flight_row_kernel<<<1, 32, 0, stream>>>(counters, partials, static_cast<int>(blocks), kinds,
                                          static_cast<int>(nseg), fmask != nullptr ? 1 : 0,
                                          rep, lanes, static_cast<int32_t>(depth), buf, cap);
  return static_cast<int>(cudaGetLastError());
}
