// K11 — the chunk budget gate at a chunk boundary of the per-goal driver —
// and K11 cross — the inter-goal pipeline's gate and its touched-broker
// accounting.
//
// cc_chunk_gate replaces cruise_control_tpu/analyzer/optimizer.py:1489
// _get_gate_fn (``packed[PACKED_CAPPED] * budget``, the on-device budget of
// a speculative follow-up chunk) together with the two ends of a chunk of
// _goal_fixpoint_budget (:1572): the packed i32[PACKED_WIDTH] row it returns
// and the initial carry of its while loop.  At a boundary, in stream order:
//   close (``packed`` not null): write the closing chunk's packed row from
//     the step counters (steps, actions, last_n, repair steps, bisect depth,
//     lanes live, budget), its satisfied-at-entry flag (``entry_before``),
//     the exit flags (satisfied, offline replicas left, frontier
//     population) and, on a pipelined run (``touched`` and ``mask`` not
//     null), the conflict count |touched ∩ mask| (:1688-1690), else 0:
//     capped = steps >= budget and last_n > 0;
//   open (``do_open``): reset the counters for the next chunk — budget the
//     host's int, or, with ``gate``, the capped flag times it: the flag of
//     the chunk closed by the same launch, or of the packed row
//     ``gate_src`` (a follow-up whose predecessor was closed earlier, when
//     a cross-goal opener was queued between them); last_n 0 when the
//     chunk's entry state is satisfied with nothing offline (the skip
//     shortcut), else 1 — and keep its satisfied-at-entry flag.
//
// cc_cross_gate replaces optimizer.py:1514 _get_cross_gate_fn: it opens
// the counters for the next goal's opening chunk, queued behind the current
// goal's authoritative chunk: budget ``budget`` if that chunk's closed row
// (``gate_src``) is satisfied, not capped, with nothing offline and no
// conflict, else 0; last_n and the satisfied-at-entry flag from the
// opener's own entry flags (the next goal's K9).
//
// cc_chunk_touched replaces the touched tail of _goal_fixpoint_budget
// (:1673-1687): every valid replica whose broker, leadership or disk
// differs from the chunk's entry snapshot marks its entry and its exit
// broker (each clipped to [0, B-1]) in ``touched``; a replica moved away and
// back marks nothing.  Plain stores of 1: racing stores of one value give
// one result.
//
// Bound: the gates move a few dozen bytes and the conflict count 2 B; the
// touched pass reads 19 bytes per replica (three placement arrays, their
// snapshot, the valid flag: about 1.9 MB at 100k replicas).  All three are
// launch-bound at the shapes of the solve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// state.py CTR_* and PACKED_* slots.
constexpr int kSteps = 0, kTotal = 1, kLastN = 2, kRepair = 3, kDepth = 4, kLanes = 5,
              kBudget = 6;
constexpr int kPackedAfter = 3, kPackedCapped = 4, kPackedOffline = 9,
              kPackedConflict = 10, kPackedWidth = 11;
constexpr int kGateThreads = 256;
constexpr int kTouchedThreads = 256;

__device__ __forceinline__ void open_counters(int32_t* counters, int32_t* entry_before,
                                              int32_t s, int32_t o, int32_t budget) {
  counters[kSteps] = 0;
  counters[kTotal] = 0;
  counters[kLastN] = (s && !o) ? 0 : 1;
  counters[kRepair] = 0;
  counters[kDepth] = 0;
  counters[kLanes] = 0;
  counters[kBudget] = budget;
  entry_before[0] = s;
}

__global__ void chunk_gate_kernel(int32_t* counters, int32_t* entry_before,
                                  const uint8_t* sat, const uint8_t* off,
                                  const int32_t* num_active, int32_t* packed,
                                  const uint8_t* touched, const uint8_t* mask, int64_t b,
                                  const int32_t* gate_src, int do_open, int gate,
                                  int32_t budget) {
  __shared__ int conflict;
  if (threadIdx.x == 0) conflict = 0;
  __syncthreads();
  if (packed != nullptr && touched != nullptr && mask != nullptr) {
    int mine = 0;
    for (int64_t i = threadIdx.x; i < b; i += blockDim.x) mine += (touched[i] && mask[i]);
    if (mine) atomicAdd(&conflict, mine);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int32_t steps = counters[kSteps], last_n = counters[kLastN];
  const int32_t capped = (steps >= counters[kBudget] && last_n > 0) ? 1 : 0;
  const int32_t s = sat[0] ? 1 : 0, o = off[0] ? 1 : 0;
  if (packed != nullptr) {
    const int32_t row[kPackedWidth] = {steps, counters[kTotal], entry_before[0], s, capped,
                                       counters[kRepair], counters[kDepth],
                                       counters[kLanes],
                                       num_active != nullptr ? num_active[0] : -1, o,
                                       conflict};
    for (int i = 0; i < kPackedWidth; ++i) packed[i] = row[i];
  }
  if (do_open) {
    const int32_t pred_capped = gate_src != nullptr ? gate_src[kPackedCapped] : capped;
    open_counters(counters, entry_before, s, o, gate ? pred_capped * budget : budget);
  }
}

__global__ void cross_gate_kernel(int32_t* counters, int32_t* entry_before,
                                  const uint8_t* sat, const uint8_t* off,
                                  const int32_t* gate_src, int32_t budget) {
  const bool done = gate_src[kPackedAfter] == 1 && gate_src[kPackedCapped] == 0 &&
                    gate_src[kPackedOffline] == 0 && gate_src[kPackedConflict] == 0;
  open_counters(counters, entry_before, sat[0] ? 1 : 0, off[0] ? 1 : 0,
                done ? budget : 0);
}

__device__ __forceinline__ int64_t clip(int32_t v, int64_t b) {
  return v < 0 ? 0 : (v >= b ? b - 1 : v);
}

__global__ void chunk_touched_kernel(int64_t r, int64_t b, const int32_t* __restrict__ rb0,
                                     const uint8_t* __restrict__ rl0,
                                     const int32_t* __restrict__ rd0,
                                     const int32_t* __restrict__ rb,
                                     const uint8_t* __restrict__ rl,
                                     const int32_t* __restrict__ rd,
                                     const uint8_t* __restrict__ valid, uint8_t* touched) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < r;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (!valid[i]) continue;
    const int32_t from = rb0[i], to = rb[i];
    if (from != to || rl0[i] != rl[i] || rd0[i] != rd[i]) {
      touched[clip(from, b)] = 1;
      touched[clip(to, b)] = 1;
    }
  }
}

}  // namespace

extern "C" int cc_chunk_gate(int32_t* counters, int32_t* entry_before, const uint8_t* sat,
                             const uint8_t* off, const int32_t* num_active,
                             int32_t* packed, const uint8_t* touched, const uint8_t* mask,
                             const int32_t* gate_src, int64_t b, int64_t do_open,
                             int64_t gate, int64_t budget, cudaStream_t stream) {
  if (!counters || !entry_before || !sat || !off || (gate && !packed && !gate_src) ||
      (!touched != !mask) || b < 0 || budget < 0 || budget > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  chunk_gate_kernel<<<1, kGateThreads, 0, stream>>>(
      counters, entry_before, sat, off, num_active, packed, touched, mask, b, gate_src,
      static_cast<int>(do_open), static_cast<int>(gate), static_cast<int32_t>(budget));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_cross_gate(int32_t* counters, int32_t* entry_before, const uint8_t* sat,
                             const uint8_t* off, const int32_t* gate_src, int64_t budget,
                             cudaStream_t stream) {
  if (!counters || !entry_before || !sat || !off || !gate_src || budget < 0 ||
      budget > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cross_gate_kernel<<<1, 1, 0, stream>>>(counters, entry_before, sat, off, gate_src,
                                         static_cast<int32_t>(budget));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_chunk_touched(int64_t r, int64_t b, const int32_t* rb0,
                                const uint8_t* rl0, const int32_t* rd0, const int32_t* rb,
                                const uint8_t* rl, const int32_t* rd, const uint8_t* valid,
                                uint8_t* touched, cudaStream_t stream) {
  if (r < 0 || b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (r + kTouchedThreads - 1) / kTouchedThreads;
  if (blocks > 4096) blocks = 4096;
  chunk_touched_kernel<<<static_cast<unsigned>(blocks), kTouchedThreads, 0, stream>>>(
      r, b, rb0, rl0, rd0, rb, rl, rd, valid, touched);
  return static_cast<int>(cudaGetLastError());
}
