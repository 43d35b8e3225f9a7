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
// the block's chains of synchronised steps are the cost.
//
// cc_frontier_active_batch replaces goals/kernels.py:912
// frontier_active_batch inside the pipeline's stack sweep
// (cruise_control_tpu/analyzer/optimizer.py:2340 _stack_frontiers): the
// stacked [G, B] metric and band rows of a goal stack, one row per goal,
// with a band flag per row; the non-band rows come out all false with a
// population of 0.  Bound: bytes (G x B rows of 13 bytes and the shared
// broker rows read, G x B + 4 G bytes written: about 40 KB for 15 goals of
// 200 brokers).
//
// Design: one block per mask (the batch: one block per row), every thread
// of it on every step.  The block takes the two totals in the order of
// ordered.cuh's block_sum (ops/order.py ordered_sum).  Each of the two
// rankings (donor surpluses, receiver rooms) is the permutation of the
// plain version's stable argsort: value descending, index ascending, +0
// equal to -0, padding last.  Up to ``rank_max`` brokers (the wrapper's
// FRONTIER_RANK_MAX_BROKERS) a thread a broker counts the brokers that come
// before its own, from the keys in shared memory, and writes its key to
// that rank: no stages, two syncs.  Above it a bitonic sort over the
// padded power of two p runs on keys held in registers, a thread holding
// the positions t, t + T, t + 2T, ... (T threads): stages whose partner
// lies in the same warp (distance under 32) exchange with __shfl_xor_sync,
// stages whose partner lies in another warp through shared memory (two
// buffers in turn, one sync a stage), stages whose partner is the thread's
// own (distance T or more) in registers.  Then the running sums, in the
// order of ops/order.py ordered_cumsum (XLA's blocked scan): each position
// scans its block of 16 with a 15-step shuffle scan, the last lane of each
// block writes the block total, one warp scans the totals in levels of 16
// in shared memory (ordered.cuh's warp_cumsum), and each position rebuilds
// its running sum as its in-block scan plus the finished level-1 value of
// the block before, as K3 does (prefix_cut.cu).  Every position then tests
// itself: before = running sum - value (one f32 subtraction, as the plain
// version takes it), before < limit and value > 0.  The card and the plain
// version agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// Brokers one block ranks: 25 bytes of shared memory each, plus the levels
// (8192 brokers: about 206 KB, above the 48 KB default, so the launch raises
// the limit).
constexpr int64_t kMaxBrokers = 8192;
constexpr int64_t kBlock = ordered::kBlock;
constexpr float kBig = 1e30f;
constexpr uint8_t kOver = 1, kUnder = 2, kDead = 4, kDonor = 8, kReceiver = 16;

__device__ __forceinline__ bool comes_before(float ka, int32_t ia, float kb, int32_t ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The broker rows of one mask.
struct Row {
  int64_t b;
  float eps;
  const float *metric, *lower, *upper;
  const uint8_t *alive, *valid;
  const int32_t* rc;
};

// The block's dynamic shared memory: two buffers of keys and indices (the
// rank pass's keys and ranked copy; the bitonic stages' exchanges), the
// levels of the running sums' block totals, the brokers' surpluses,
// deficits and flags.
struct Shared {
  float* key[2];
  int32_t* idx[2];
  float *levels, *surplus, *deficit;
  uint8_t* flags;
};

__host__ __device__ inline int64_t slots(int p, int threads) { return p > threads ? p : threads; }

__host__ __device__ inline int64_t blocks_of(int64_t b) { return (b + kBlock - 1) / kBlock; }

__device__ Shared carve(int64_t cap, int64_t b) {
  extern __shared__ unsigned char smem[];
  Shared s;
  s.key[0] = reinterpret_cast<float*>(smem);
  s.key[1] = s.key[0] + cap;
  s.idx[0] = reinterpret_cast<int32_t*>(s.key[1] + cap);
  s.idx[1] = s.idx[0] + cap;
  s.levels = reinterpret_cast<float*>(s.idx[1] + cap);
  s.surplus = s.levels + ordered::level_floats(blocks_of(b));
  s.deficit = s.surplus + b;
  s.flags = reinterpret_cast<uint8_t*>(s.deficit + b);
  return s;
}

// A broker's share of the two totals, from the row and its flags, and
// whether it is a pull donor.
struct Terms {
  float surplus, deficit;
  bool donor;
};

__device__ __forceinline__ Terms terms(const Row& r, int64_t i, uint8_t f, bool under_exists) {
  const bool al = r.alive[i];
  const float m = r.metric[i], lo = r.lower[i], up = r.upper[i];
  const float target = up >= kBig ? m : __fmul_rn(__fadd_rn(lo, up), 0.5f);
  const float shed_to = under_exists ? fminf(target, up) : up;
  const float s_alive = al ? fmaxf(__fsub_rn(m, shed_to), 0.f) : 0.f;
  const float s_dead = (f & kDead) ? fmaxf(m, 0.f) : 0.f;
  return Terms{__fadd_rn(s_alive, s_dead), (f & kUnder) ? fmaxf(__fsub_rn(lo, m), 0.f) : 0.f,
               al && m > __fadd_rn(shed_to, r.eps)};
}

// Sorts the block's keys into comes_before order.  Slot q of thread t holds
// position q * T + t (T = blockDim.x) before and after.  The rank pass
// (E = 1, b <= T) reads only positions below b.
template <int E>
__device__ __forceinline__ void rank_sort(float (&key)[E], int32_t (&idx)[E], int64_t b,
                                          const Shared& sh) {
  const int t = threadIdx.x;
  sh.key[0][t] = key[0];
  __syncthreads();
  if (t < b) {
    const float mine = key[0];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < b; ++j) r += comes_before(sh.key[0][j], j, mine, t);
    sh.key[1][r] = mine;
    sh.idx[1][r] = t;
  }
  __syncthreads();
  if (t < b) {
    key[0] = sh.key[1][t];
    idx[0] = sh.idx[1][t];
  }
}

// Position i's new entry from its partner's (pk, pi) at a stage (k, j) of
// the bitonic network: the lower position of an ascending pair keeps the
// entry that comes first, and so on.
__device__ __forceinline__ void exchange(float& key, int32_t& idx, float pk, int32_t pi, int i,
                                         int j, int k) {
  const bool lower = (i & j) == 0, up = (i & k) == 0;
  const bool partner_first = comes_before(pk, pi, key, idx);
  if (lower == up ? partner_first : !partner_first) {
    key = pk;
    idx = pi;
  }
}

template <int E>
__device__ __forceinline__ void bitonic_sort(float (&key)[E], int32_t (&idx)[E], int p,
                                             const Shared& sh) {
  const int t = threadIdx.x, nt = blockDim.x;
  int turn = 0;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= nt) {  // the partner is another slot of this thread
        const int m = j / nt;
#pragma unroll
        for (int q = 0; q < E; ++q) {
#pragma unroll
          for (int q2 = q + 1; q2 < E; ++q2) {
            if (q2 != (q ^ m)) continue;
            const bool up = ((q * nt + t) & k) == 0;
            const bool swap = up ? comes_before(key[q2], idx[q2], key[q], idx[q])
                                 : comes_before(key[q], idx[q], key[q2], idx[q2]);
            if (swap) {
              const float tk = key[q];
              key[q] = key[q2];
              key[q2] = tk;
              const int32_t ti = idx[q];
              idx[q] = idx[q2];
              idx[q2] = ti;
            }
          }
        }
      } else if (j >= 32) {  // in another warp: through shared memory
        float* kb = sh.key[turn & 1];
        int32_t* ib = sh.idx[turn & 1];
        ++turn;
#pragma unroll
        for (int q = 0; q < E; ++q) {
          kb[q * nt + t] = key[q];
          ib[q * nt + t] = idx[q];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < E; ++q) {
          const int i = q * nt + t, l = i ^ j;
          exchange(key[q], idx[q], kb[l], ib[l], i, j, k);
        }
      } else {  // in this warp: registers
#pragma unroll
        for (int q = 0; q < E; ++q) {
          const float pk = __shfl_xor_sync(kFull, key[q], j);
          const int32_t pi = __shfl_xor_sync(kFull, idx[q], j);
          exchange(key[q], idx[q], pk, pi, q * nt + t, j, k);
        }
      }
    }
  }
}

// Ranks the keys, then sets ``bit`` in the flags of the leading entries
// whose running sum before them stays under ``limit`` (and whose value is
// positive).  Every thread of the block calls it.
template <int E>
__device__ __forceinline__ void mark_prefix(float (&key)[E], int32_t (&idx)[E], int64_t b, int p,
                             bool by_rank, float limit, uint8_t bit, const Shared& sh) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  if (by_rank)
    rank_sort<E>(key, idx, b, sh);
  else
    bitonic_sort<E>(key, idx, p, sh);
  const int64_t nb = blocks_of(b);
  float scan[E], val[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = q * nt + t;
    const float v = i < b ? key[q] : 0.f;
    float acc = v;
#pragma unroll
    for (int s = 1; s < kBlock; ++s) {  // lane s of a block adds lane s - 1's finished scan
      const float prev = __shfl_up_sync(kFull, acc, 1);
      if ((lane & (kBlock - 1)) == s) acc = __fadd_rn(v, prev);
    }
    val[q] = v;
    scan[q] = acc;
    if ((i & (kBlock - 1)) == kBlock - 1 && i / kBlock < nb) sh.levels[i / kBlock] = acc;
  }
  __syncthreads();
  if (t < 32) ordered::warp_cumsum(sh.levels, nb);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = q * nt + t;
    if (i >= b) continue;
    const float cs = i >= kBlock ? __fadd_rn(scan[q], sh.levels[i / kBlock - 1]) : scan[q];
    const float before = __fsub_rn(cs, val[q]);
    if (before < limit && val[q] > 0.f) sh.flags[idx[q]] |= bit;
  }
  __syncthreads();
}

// One block computes the mask of one row.
template <int E>
__device__ __forceinline__ void frontier_row(const Row r, int p, bool by_rank, uint8_t* active,
                             int32_t* count) {
  __shared__ float sum_scratch[kMaxBrokers / ordered::kWindow];
  __shared__ float sum_out[1];
  __shared__ int under_exists;
  __shared__ int population;
  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t b = r.b;
  const Shared sh = carve(slots(p, nt), b);
  if (t == 0) {
    under_exists = 0;
    population = 0;
  }
  __syncthreads();
  for (int64_t i = t; i < b; i += nt) {
    const bool al = r.alive[i];
    const float m = r.metric[i];
    uint8_t f = 0;
    if (al && m > __fadd_rn(r.upper[i], r.eps)) f |= kOver;
    if (al && m < __fsub_rn(r.lower[i], r.eps)) f |= kUnder;
    if (!al && r.valid[i] && r.rc[i] > 0) f |= kDead;
    sh.flags[i] = f;
    if (f & kUnder) under_exists = 1;
  }
  __syncthreads();
  const bool under = under_exists != 0;
  float key[E];
  int32_t idx[E];
  // Donor surpluses (padding: -inf, last), each broker's terms kept for
  // the totals.
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = q * nt + t;
    idx[q] = i;
    key[q] = -INFINITY;
    if (i < b) {
      const Terms x = terms(r, i, sh.flags[i], under);
      sh.surplus[i] = x.surplus;
      sh.deficit[i] = x.deficit;
      key[q] = x.donor ? x.surplus : 0.f;
    }
  }
  __syncthreads();
  const float total_surplus =
      ordered::block_sum(ordered::Array{sh.surplus}, b, sum_scratch, sum_out);
  const float total_deficit =
      ordered::block_sum(ordered::Array{sh.deficit}, b, sum_scratch, sum_out);
  mark_prefix<E>(key, idx, b, p, by_rank, __fmul_rn(2.f, total_deficit), kDonor, sh);
  // Receiver rooms.
  if (total_surplus > 0.f) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = q * nt + t;
      idx[q] = i;
      if (i < b) {
        const bool ok = r.alive[i] && !(sh.flags[i] & kOver);
        key[q] = ok ? fmaxf(__fsub_rn(fminf(r.upper[i], kBig), r.metric[i]), 0.f) : 0.f;
      } else {
        key[q] = -INFINITY;
      }
    }
    mark_prefix<E>(key, idx, b, p, by_rank, __fmul_rn(2.f, total_surplus), kReceiver, sh);
  }
  int mine = 0;
  for (int64_t i = t; i < b; i += nt) {
    const bool on = sh.flags[i] != 0;
    active[i] = on;
    mine += on;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_xor_sync(kFull, mine, off);
  if ((t & 31) == 0) atomicAdd(&population, mine);
  __syncthreads();
  if (t == 0) count[0] = population;
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads) frontier_active_kernel(
    const Row r, int p, bool by_rank, uint8_t* active, int32_t* count) {
  frontier_row<E>(r, p, by_rank, active, count);
}

// Block g: row g of the stacked [G, B] inputs, or an all-false row for a
// goal that is not of a band kind.
template <int E>
__global__ void __launch_bounds__(kMaxThreads) frontier_active_batch_kernel(
    Row r, int p, bool by_rank, const uint8_t* __restrict__ band,
    const float* __restrict__ eps, uint8_t* active, int32_t* count) {
  const int64_t g = blockIdx.x;
  const int64_t off = g * r.b;
  if (!band[g]) {
    for (int64_t i = threadIdx.x; i < r.b; i += blockDim.x) active[off + i] = 0;
    if (threadIdx.x == 0) count[g] = 0;
    return;
  }
  r.eps = eps[g];
  r.metric += off;
  r.lower += off;
  r.upper += off;
  frontier_row<E>(r, p, by_rank, active + off, count + g);
}

// The launch shape of b brokers: the padded power of two p, whether the
// rank pass sorts, the block's threads and each thread's slots E.
struct Shape {
  int p, threads, per;
  bool by_rank;
  size_t smem;
};

Shape shape_of(int64_t b, int64_t rank_max) {
  Shape s;
  s.p = 1;
  while (s.p < b) s.p <<= 1;
  s.by_rank = b <= rank_max;
  if (s.by_rank) {
    s.threads = static_cast<int>((b + 31) / 32 * 32);
    s.per = 1;
  } else {
    const int padded = s.p > 32 ? s.p : 32;
    s.threads = padded < kMaxThreads ? padded : kMaxThreads;
    s.per = padded / s.threads;
  }
  s.smem = static_cast<size_t>(slots(s.p, s.threads)) * 16 +
           static_cast<size_t>(ordered::level_floats(blocks_of(b))) * 4 +
           static_cast<size_t>(b) * 9;
  return s;
}

// Raises the kernel's dynamic shared memory limit when the shape needs more
// than the 48 KB default, then launches it.
template <typename K, typename... Args>
int launch(K kernel, unsigned grid, const Shape& s, cudaStream_t stream, Args... args) {
  if (s.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s.smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, s.threads, s.smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int64_t b, int64_t rank_max) {
  return b > 0 && b <= kMaxBrokers && rank_max >= 0 && rank_max <= kMaxThreads;
}

}  // namespace

// rank_max: the most brokers the rank pass sorts (at most 1,024); above it
// the bitonic sort.
extern "C" int cc_frontier_active(int64_t b, int64_t rank_max, float eps, const float* metric,
                                  const float* lower, const float* upper,
                                  const uint8_t* alive, const uint8_t* valid,
                                  const int32_t* rc, uint8_t* active, int32_t* count,
                                  cudaStream_t stream) {
  if (!valid_shape(b, rank_max)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(b, rank_max);
  const Row r{b, eps, metric, lower, upper, alive, valid, rc};
  switch (s.per) {
    case 1: return launch(frontier_active_kernel<1>, 1, s, stream, r, s.p, s.by_rank, active, count);
    case 2: return launch(frontier_active_kernel<2>, 1, s, stream, r, s.p, s.by_rank, active, count);
    case 4: return launch(frontier_active_kernel<4>, 1, s, stream, r, s.p, s.by_rank, active, count);
    default: return launch(frontier_active_kernel<8>, 1, s, stream, r, s.p, s.by_rank, active, count);
  }
}

extern "C" int cc_frontier_active_batch(int64_t g, int64_t b, int64_t rank_max,
                                        const uint8_t* band, const float* eps,
                                        const float* metric, const float* lower,
                                        const float* upper, const uint8_t* alive,
                                        const uint8_t* valid, const int32_t* rc,
                                        uint8_t* active, int32_t* count, cudaStream_t stream) {
  if (g <= 0 || g > 65535 || !valid_shape(b, rank_max))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(b, rank_max);
  const Row r{b, 0.f, metric, lower, upper, alive, valid, rc};
  const unsigned grid = static_cast<unsigned>(g);
  switch (s.per) {
    case 1:
      return launch(frontier_active_batch_kernel<1>, grid, s, stream, r, s.p, s.by_rank, band,
                    eps, active, count);
    case 2:
      return launch(frontier_active_batch_kernel<2>, grid, s, stream, r, s.p, s.by_rank, band,
                    eps, active, count);
    case 4:
      return launch(frontier_active_batch_kernel<4>, grid, s, stream, r, s.p, s.by_rank, band,
                    eps, active, count);
    default:
      return launch(frontier_active_batch_kernel<8>, grid, s, stream, r, s.p, s.by_rank, band,
                    eps, active, count);
  }
}
