// K7 — apply the selected candidate actions to the placement arrays.
//
// Replaces cruise_control_tpu/analyzer/actions.py:233 apply_candidates with
// model/tensor_model.py:240 relocate_replicas, :266 relocate_leadership and
// :282 relocate_replicas_to_disk: masked add-of-delta scatters into
// replica_broker, replica_disk and replica_is_leader for the five action
// kinds (move, leadership, intra-broker move, swap, intra-broker swap).
//
// Bound on the card: bytes (K * 33 read, plus the placement arrays the
// caller copies); a few hundred KB per step, so launch-bound.
//
// Design: one thread per lane, direct stores.  The selection guarantees
// partition uniqueness per step (optimizer.select_batched), so no replica
// has two unmasked lanes and a direct store equals the JAX add-of-delta.
// A leadership lane stores old <- 0 before new <- 1, so a lane whose
// dest_replica falls back to its own replica leaves it leading.  The
// caller passes fresh copies of the three placement tensors; the kernel
// writes only the lanes it applies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum ActionType : int32_t {
  kMove = 0,
  kLeadership = 1,
  kIntraMove = 2,
  kSwap = 3,
  kIntraSwap = 4,
};

__global__ void apply_actions_kernel(
    const int32_t* __restrict__ action_type,
    const int32_t* __restrict__ replica, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dest, const int32_t* __restrict__ dest_replica,
    const int32_t* __restrict__ src_disk, const int32_t* __restrict__ dest_disk,
    const uint8_t* __restrict__ apply_mask,
    const int32_t* __restrict__ broker_first_disk, int64_t k,
    int64_t num_replicas, int64_t num_brokers,
    int32_t* __restrict__ replica_broker, int32_t* __restrict__ replica_disk,
    uint8_t* __restrict__ replica_is_leader) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= k || !apply_mask[i]) return;
  const int32_t r = replica[i];
  const int32_t r2 = dest_replica[i] >= 0 ? dest_replica[i] : r;
  if (r < 0 || r >= num_replicas || r2 >= num_replicas) return;
  switch (action_type[i]) {
    case kMove: {
      const int32_t d = dest[i];
      if (d < 0 || d >= num_brokers) return;
      replica_broker[r] = d;
      replica_disk[r] = broker_first_disk[d];
      break;
    }
    case kLeadership:
      replica_is_leader[r] = 0;
      replica_is_leader[r2] = 1;
      break;
    case kIntraMove:
      replica_disk[r] = dest_disk[i];
      break;
    case kSwap: {
      const int32_t d = dest[i];
      const int32_t s = src[i];
      if (d < 0 || d >= num_brokers || s < 0 || s >= num_brokers) return;
      replica_broker[r] = d;
      replica_disk[r] = broker_first_disk[d];
      replica_broker[r2] = s;
      replica_disk[r2] = broker_first_disk[s];
      break;
    }
    case kIntraSwap:
      replica_disk[r] = dest_disk[i];
      replica_disk[r2] = src_disk[i];
      break;
    default:
      break;
  }
}

}  // namespace

extern "C" int cc_apply_actions(
    const int32_t* action_type, const int32_t* replica, const int32_t* src,
    const int32_t* dest, const int32_t* dest_replica, const int32_t* src_disk,
    const int32_t* dest_disk, const uint8_t* apply_mask,
    const int32_t* broker_first_disk, int64_t k, int64_t num_replicas,
    int64_t num_brokers, int32_t* replica_broker, int32_t* replica_disk,
    uint8_t* replica_is_leader, cudaStream_t stream) {
  if (k <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  apply_actions_kernel<<<blocks, kThreads, 0, stream>>>(
      action_type, replica, src, dest, dest_replica, src_disk, dest_disk,
      apply_mask, broker_first_disk, k, num_replicas, num_brokers,
      replica_broker, replica_disk, replica_is_leader);
  return static_cast<int>(cudaGetLastError());
}
