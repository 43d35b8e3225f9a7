// K11 — the chunk budget gate at a chunk boundary of the per-goal driver.
//
// Replaces cruise_control_tpu/analyzer/optimizer.py:1489 _get_gate_fn
// (``packed[PACKED_CAPPED] * budget``, the on-device budget of a speculative
// follow-up chunk) together with the two ends of a chunk of
// _goal_fixpoint_budget (:1572): the packed i32[PACKED_WIDTH] row it returns
// and the initial carry of its while loop.  At a boundary, in stream order:
//   close (``packed`` not null): write the closing chunk's packed row from
//     the step counters (steps, actions, last_n, repair steps, bisect depth,
//     lanes live, budget), its satisfied-at-entry flag (``entry_before``)
//     and the exit flags (satisfied, offline replicas left, frontier
//     population): capped = steps >= budget and last_n > 0;
//   open (``do_open``): reset the counters for the next chunk — budget the
//     host's int, or, with ``gate``, the closed chunk's capped flag times
//     it; last_n 0 when the chunk's entry state is satisfied with nothing
//     offline (the skip shortcut), else 1 — and keep its satisfied-at-entry
//     flag.  A follow-up opened by the same launch that closes its
//     predecessor starts from the predecessor's exit state, so the exit
//     flags are its entry flags.
// The follow-up's replays can then be queued before the host reads the
// predecessor's row: a converged predecessor gives it a budget of 0, and
// every gated step of it is a no-op.
//
// Bound: a few dozen bytes; one thread.  The launch is the cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// state.py CTR_* and PACKED_* slots.
constexpr int kSteps = 0, kTotal = 1, kLastN = 2, kRepair = 3, kDepth = 4, kLanes = 5,
              kBudget = 6;
constexpr int kPackedWidth = 11;

__global__ void chunk_gate_kernel(int32_t* counters, int32_t* entry_before,
                                  const uint8_t* sat, const uint8_t* off,
                                  const int32_t* num_active, int32_t* packed, int do_open,
                                  int gate, int32_t budget) {
  const int32_t steps = counters[kSteps], last_n = counters[kLastN];
  const int32_t capped = (steps >= counters[kBudget] && last_n > 0) ? 1 : 0;
  const int32_t s = sat[0] ? 1 : 0, o = off[0] ? 1 : 0;
  if (packed != nullptr) {
    const int32_t row[kPackedWidth] = {steps, counters[kTotal], entry_before[0], s, capped,
                                       counters[kRepair], counters[kDepth],
                                       counters[kLanes],
                                       num_active != nullptr ? num_active[0] : -1, o, 0};
    for (int i = 0; i < kPackedWidth; ++i) packed[i] = row[i];
  }
  if (do_open) {
    counters[kSteps] = 0;
    counters[kTotal] = 0;
    counters[kLastN] = (s && !o) ? 0 : 1;
    counters[kRepair] = 0;
    counters[kDepth] = 0;
    counters[kLanes] = 0;
    counters[kBudget] = gate ? capped * budget : budget;
    entry_before[0] = s;
  }
}

}  // namespace

extern "C" int cc_chunk_gate(int32_t* counters, int32_t* entry_before, const uint8_t* sat,
                             const uint8_t* off, const int32_t* num_active,
                             int32_t* packed, int64_t do_open, int64_t gate, int64_t budget,
                             cudaStream_t stream) {
  if (!counters || !entry_before || !sat || !off || (gate && !packed) ||
      budget < 0 || budget > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  chunk_gate_kernel<<<1, 1, 0, stream>>>(counters, entry_before, sat, off, num_active,
                                         packed, static_cast<int>(do_open),
                                         static_cast<int>(gate),
                                         static_cast<int32_t>(budget));
  return static_cast<int>(cudaGetLastError());
}
