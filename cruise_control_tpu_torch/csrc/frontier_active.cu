// K9, frontier mask — the active broker set of one band goal — and K9,
// batch — every goal's frontier of a stack in one launch.
//
// cc_frontier_active replaces cruise_control_tpu/analyzer/goals/kernels.py:842
// frontier_active:
// from a band goal's metric and band per broker, the set of brokers that can
// matter to the goal's next steps —
//   the out-of-band brokers and the dead brokers still hosting replicas;
//   the pull donors (alive, above the shed target) in descending-surplus
//   order until their running surplus covers twice the under-band deficit;
//   the receivers (alive, not over) in descending-room order until their
//   running room covers twice the remaining surplus.
// Output: bool[B] and its population.
//
// Bound on the card: bytes (B rows of 18 bytes read, B + 4 bytes written:
// under 20 KB at 1000 brokers, nanoseconds at 3.35 TB/s).  The launch and
// the block's sequential scan dominate.
//
// cc_frontier_active_batch replaces goals/kernels.py:912
// frontier_active_batch inside the pipeline's stack sweep
// (cruise_control_tpu/analyzer/optimizer.py:2340 _stack_frontiers): the
// stacked [G, B] metric and band rows of a goal stack, one row per goal,
// with a band flag per row; the non-band rows come out all false with a
// population of 0.  Bound: bytes (G x B rows of 13 bytes and the shared
// broker rows read, G x B + 4 G bytes written: about 40 KB for 15 goals of
// 200 brokers), so the launch and each block's serial running sums are
// the cost.
//
// Design: one block per mask (the batch: one block per row, each running
// the single mask's body on its row).  The donor surpluses and the receiver rooms are each
// sorted in shared memory by a bitonic sort on (value descending, index
// ascending), which is the permutation of the plain version's stable
// argsort.  The block takes the two totals, and one thread the running
// sums, in the orders of ordered.cuh (ops/order.py ordered_sum and
// ordered_cumsum: the JAX package's rounding), as the plain version does,
// so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr int kThreads = 1024;
// Brokers one block sorts: 21 bytes of shared memory each (8192 brokers:
// 172 KB, above the 48 KB default, so the launch raises the limit).
constexpr int64_t kMaxBrokers = 8192;
constexpr float kBig = 1e30f;
constexpr uint8_t kOver = 1, kUnder = 2, kDead = 4, kDonor = 8, kReceiver = 16;

__device__ __forceinline__ bool comes_before(float ka, int32_t ia, float kb, int32_t ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Sorts key/idx[0, p) (p a power of two) into comes_before order.
__device__ void bitonic_sort(float* key, int32_t* idx, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l <= i) continue;
        const bool up = (i & k) == 0;
        const bool swap = up ? comes_before(key[l], idx[l], key[i], idx[i])
                             : comes_before(key[i], idx[i], key[l], idx[l]);
        if (swap) {
          const float tk = key[i];
          key[i] = key[l];
          key[l] = tk;
          const int32_t ti = idx[i];
          idx[i] = idx[l];
          idx[l] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// Thread 0: mark the leading sorted entries whose running sum before them
// stays under ``limit`` (and whose value is positive).
__device__ void mark_leading(const float* key, const int32_t* idx, int64_t b, float limit,
                             uint8_t* flags, uint8_t bit, float* cs, float* scratch) {
  for (int64_t j = 0; j < b; ++j) cs[j] = key[j];
  ordered::serial_cumsum(cs, b, scratch);
  for (int64_t j = 0; j < b; ++j) {
    const float v = key[j];
    const float before = __fsub_rn(cs[j], v);
    if (before < limit && v > 0.f) flags[idx[j]] |= bit;
  }
}

// One block computes the mask of one row.
__device__ void frontier_row(int64_t b, int p, float eps, const float* __restrict__ metric,
                             const float* __restrict__ lower,
                             const float* __restrict__ upper,
                             const uint8_t* __restrict__ alive,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ rc, uint8_t* active,
                             int32_t* count) {
  extern __shared__ unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);              // [p]
  int32_t* idx = reinterpret_cast<int32_t*>(key + p);       // [p]
  float* surplus = reinterpret_cast<float*>(idx + p);       // [b]
  float* deficit = surplus + b;                             // [b]
  float* cs = deficit + b;                                  // [b]
  uint8_t* flags = reinterpret_cast<uint8_t*>(cs + b);      // [b]
  __shared__ float scratch[kMaxBrokers / 15 + 16];
  __shared__ int under_exists;
  __shared__ float sum_out[1];
  __shared__ int population;
  const int t = threadIdx.x;
  if (t == 0) {
    under_exists = 0;
    population = 0;
  }
  __syncthreads();
  for (int64_t i = t; i < b; i += blockDim.x) {
    const bool al = alive[i];
    const float m = metric[i];
    uint8_t f = 0;
    if (al && m > __fadd_rn(upper[i], eps)) f |= kOver;
    if (al && m < __fsub_rn(lower[i], eps)) f |= kUnder;
    if (!al && valid[i] && rc[i] > 0) f |= kDead;
    flags[i] = f;
    if (f & kUnder) under_exists = 1;
  }
  __syncthreads();
  // Donor surpluses into the sort keys; surplus and deficit kept for the
  // totals.
  for (int64_t i = t; i < p; i += blockDim.x) {
    if (i >= b) {
      key[i] = -INFINITY;
      idx[i] = static_cast<int32_t>(i);
      continue;
    }
    const bool al = alive[i];
    const float m = metric[i], lo = lower[i], up = upper[i];
    const float target = up >= kBig ? m : __fmul_rn(__fadd_rn(lo, up), 0.5f);
    const float shed_to = under_exists ? fminf(target, up) : up;
    const bool donor = al && m > __fadd_rn(shed_to, eps);
    const float s_alive = al ? fmaxf(__fsub_rn(m, shed_to), 0.f) : 0.f;
    const float s_dead = (flags[i] & kDead) ? fmaxf(m, 0.f) : 0.f;
    const float s = __fadd_rn(s_alive, s_dead);
    surplus[i] = s;
    deficit[i] = (flags[i] & kUnder) ? fmaxf(__fsub_rn(lo, m), 0.f) : 0.f;
    key[i] = donor ? s : 0.f;
    idx[i] = static_cast<int32_t>(i);
  }
  __syncthreads();
  const float total_surplus =
      ordered::block_sum(ordered::Array{surplus}, b, scratch, sum_out);
  const float total_deficit =
      ordered::block_sum(ordered::Array{deficit}, b, scratch, sum_out);
  bitonic_sort(key, idx, p);
  if (t == 0)
    mark_leading(key, idx, b, __fmul_rn(2.f, total_deficit), flags, kDonor, cs, scratch);
  __syncthreads();
  // Receiver rooms.
  for (int64_t i = t; i < p; i += blockDim.x) {
    if (i >= b) {
      key[i] = -INFINITY;
      idx[i] = static_cast<int32_t>(i);
      continue;
    }
    const bool ok = alive[i] && !(flags[i] & kOver);
    key[i] = ok ? fmaxf(__fsub_rn(fminf(upper[i], kBig), metric[i]), 0.f) : 0.f;
    idx[i] = static_cast<int32_t>(i);
  }
  __syncthreads();
  bitonic_sort(key, idx, p);
  if (t == 0 && total_surplus > 0.f)
    mark_leading(key, idx, b, __fmul_rn(2.f, total_surplus), flags, kReceiver, cs,
                 scratch);
  __syncthreads();
  int mine = 0;
  for (int64_t i = t; i < b; i += blockDim.x) {
    const bool on = flags[i] != 0;
    active[i] = on;
    mine += on;
  }
  atomicAdd(&population, mine);
  __syncthreads();
  if (t == 0) count[0] = population;
}

__global__ void frontier_active_kernel(int64_t b, int p, float eps,
                                       const float* __restrict__ metric,
                                       const float* __restrict__ lower,
                                       const float* __restrict__ upper,
                                       const uint8_t* __restrict__ alive,
                                       const uint8_t* __restrict__ valid,
                                       const int32_t* __restrict__ rc, uint8_t* active,
                                       int32_t* count) {
  frontier_row(b, p, eps, metric, lower, upper, alive, valid, rc, active, count);
}

// Block g: row g of the stacked [G, B] inputs, or an all-false row for a
// goal that is not of a band kind.
__global__ void frontier_active_batch_kernel(int64_t b, int p,
                                             const uint8_t* __restrict__ band,
                                             const float* __restrict__ eps,
                                             const float* __restrict__ metric,
                                             const float* __restrict__ lower,
                                             const float* __restrict__ upper,
                                             const uint8_t* __restrict__ alive,
                                             const uint8_t* __restrict__ valid,
                                             const int32_t* __restrict__ rc,
                                             uint8_t* active, int32_t* count) {
  const int64_t g = blockIdx.x;
  const int64_t off = g * b;
  if (!band[g]) {
    for (int64_t i = threadIdx.x; i < b; i += blockDim.x) active[off + i] = 0;
    if (threadIdx.x == 0) count[g] = 0;
    return;
  }
  frontier_row(b, p, eps[g], metric + off, lower + off, upper + off, alive, valid, rc,
               active + off, count + g);
}

// Dynamic shared memory of one block (sort keys and indices over the
// power-of-two p, the surplus, deficit and running sums and the flags over
// b), raising the kernel's limit when it is above the 48 KB default.
template <typename K>
cudaError_t shared_for(K kernel, int64_t b, int* p_out, size_t* smem_out) {
  int p = 1;
  while (p < b) p <<= 1;
  const size_t smem = static_cast<size_t>(p) * 8 + static_cast<size_t>(b) * 13;
  *p_out = p;
  *smem_out = smem;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace

extern "C" int cc_frontier_active(int64_t b, float eps, const float* metric,
                                  const float* lower, const float* upper,
                                  const uint8_t* alive, const uint8_t* valid,
                                  const int32_t* rc, uint8_t* active, int32_t* count,
                                  cudaStream_t stream) {
  if (b <= 0 || b > kMaxBrokers) return static_cast<int>(cudaErrorInvalidValue);
  int p;
  size_t smem;
  const cudaError_t rc_attr = shared_for(frontier_active_kernel, b, &p, &smem);
  if (rc_attr != cudaSuccess) return static_cast<int>(rc_attr);
  frontier_active_kernel<<<1, kThreads, smem, stream>>>(b, p, eps, metric, lower, upper,
                                                        alive, valid, rc, active, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_frontier_active_batch(int64_t g, int64_t b, const uint8_t* band,
                                        const float* eps, const float* metric,
                                        const float* lower, const float* upper,
                                        const uint8_t* alive, const uint8_t* valid,
                                        const int32_t* rc, uint8_t* active,
                                        int32_t* count, cudaStream_t stream) {
  if (g <= 0 || g > 65535 || b <= 0 || b > kMaxBrokers)
    return static_cast<int>(cudaErrorInvalidValue);
  int p;
  size_t smem;
  const cudaError_t rc_attr = shared_for(frontier_active_batch_kernel, b, &p, &smem);
  if (rc_attr != cudaSuccess) return static_cast<int>(rc_attr);
  frontier_active_batch_kernel<<<static_cast<unsigned>(g), kThreads, smem, stream>>>(
      b, p, band, eps, metric, lower, upper, alive, valid, rc, active, count);
  return static_cast<int>(cudaGetLastError());
}
