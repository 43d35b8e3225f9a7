// K14 — the fleet's metric-anomaly and slow-broker scorer.
//
// Replaces cruise_control_tpu/detector/device.py:60 _masked_percentile and
// :77 _device_scores (one jitted program per threshold tuple, :125): over
// f32[E, W] flush-time values, f32[E, W] bytes-in and bool[E, W] window
// validity (the last window is the latest, the W - 1 before it the
// history), per broker the metric-anomaly flag and ratio and the
// slow-broker suspect flag.  Two launches:
//
//   peer pass  one block: the percentile, across brokers, of the valid
//              latest values (the slow-broker peer anchor), into f32[1];
//   row pass   one thread per broker: three masked percentiles of its
//              history (the values at the anomaly percentile and at the
//              slow-broker percentile, the bytes-normalised values at the
//              slow-broker percentile) and the flags, reading the anchor.
//
// The percentile is the JAX package's, as its tests run it: invalid
// entries take the value FLT_MAX and sort with the rest (lax.sort's total
// order: -0 as +0, NaN last); rank = q * f32(max(n - 1, 0)) with q =
// f32(pct / 100) rounded on the host; lo = floor(rank), hi = min(lo + 1,
// max(n - 1, 0)), frac = rank - lo; result x_lo + frac * (x_hi - x_lo) with
// the multiply and the add rounded separately (__fmul_rn, __fadd_rn: nvcc
// would otherwise contract them into an fma), 0 when n is 0.  Divisions are
// IEEE (__fdiv_rn); maxima propagate NaN like jnp.maximum.
//
// Bound on the card: bytes.  At E = 7,000 and W = 20 the row pass reads
// 1.26 MB and writes 42 KB (~0.4 us at 3.35 TB/s) and the peer pass reads
// 35 KB: both far below a launch's cost.
//
// Design, simple and exact first: the row pass ranks a row's W - 1 keys by
// counting (entry i sits at #{j: k_j < k_i} + #{j < i: k_j == k_i}, the
// stable sorted position) and picks the entries at lo and hi, O(W^2) per
// row in registers and local memory; W is at most kMaxWindows.  The peer
// pass crosses blocks, so it runs first as one block that bitonic-sorts
// the E (key, row) pairs (8 bytes each) in dynamic shared memory; E is at
// most kMaxPeers (128 KB).  No atomics, no reductions in float: the result
// is bit for bit the plain version's.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWindows = 64;
constexpr int64_t kMaxPeers = 16384;
constexpr int kPeerThreads = 1024;
constexpr int kRowThreads = 128;
constexpr float kEps = 1e-9f;

// lax.sort's order of a float as a signed int: -0 counts as +0 and every
// NaN as the canonical positive NaN, which sorts after +inf.
__device__ __forceinline__ int32_t order_key(float x) {
  if (isnan(x)) return 0x7fc00000;
  if (x == 0.f) return 0;
  const int32_t b = __float_as_int(x);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float interpolate(float x_lo, float x_hi, float frac) {
  return __fadd_rn(x_lo, __fmul_rn(frac, __fsub_rn(x_hi, x_lo)));
}

struct Rank {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Rank rank_of(int n, float q) {
  const int nm1 = n > 0 ? n - 1 : 0;
  const float rank = __fmul_rn(q, static_cast<float>(nm1));
  Rank r;
  r.lo = static_cast<int>(floorf(rank));
  r.hi = min(r.lo + 1, nm1);
  r.frac = __fsub_rn(rank, static_cast<float>(r.lo));
  return r;
}

// Sorted position of each of the m keys (stable).
__device__ __forceinline__ void positions(const int32_t* keys, int m, int* pos) {
  for (int i = 0; i < m; ++i) {
    int p = 0;
    for (int j = 0; j < m; ++j) p += (keys[j] < keys[i]) || (keys[j] == keys[i] && j < i);
    pos[i] = p;
  }
}

// The percentile at rank r of the m entries x (FLT_MAX where invalid) whose
// sorted positions are pos; n of them valid.
__device__ __forceinline__ float select_percentile(const float* x, const int* pos, int m,
                                                   int n, Rank r) {
  float x_lo = FLT_MAX, x_hi = FLT_MAX;
  for (int i = 0; i < m; ++i) {
    if (pos[i] == r.lo) x_lo = x[i];
    if (pos[i] == r.hi) x_hi = x[i];
  }
  return n > 0 ? interpolate(x_lo, x_hi, r.frac) : 0.f;
}

__global__ void detector_peer_kernel(const float* __restrict__ vals,
                                     const uint8_t* __restrict__ wvalid, int64_t e,
                                     int64_t w, int64_t p2, float q,
                                     float* __restrict__ out) {
  extern __shared__ long long s_pairs[];
  const int t = threadIdx.x;
  int valid_total = 0;
  for (int64_t base = 0; base < p2; base += kPeerThreads) {
    const int64_t i = base + t;
    long long pair = LLONG_MAX;  // padding sorts after every real entry
    bool ok = false;
    if (i < e) {
      ok = wvalid[i * w + w - 1] != 0;
      const float x = ok ? vals[i * w + w - 1] : FLT_MAX;
      pair = static_cast<long long>(order_key(x)) * 4294967296LL + i;
    }
    if (i < p2) s_pairs[i] = pair;
    valid_total += __syncthreads_count(ok);
  }
  __syncthreads();
  for (int64_t k = 2; k <= p2; k <<= 1) {
    for (int64_t j = k >> 1; j > 0; j >>= 1) {
      for (int64_t i = t; i < p2; i += kPeerThreads) {
        const int64_t ixj = i ^ j;
        if (ixj > i) {
          const long long a = s_pairs[i], b = s_pairs[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s_pairs[i] = b;
            s_pairs[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (t == 0) {
    const int n = valid_total;
    const Rank r = rank_of(n, q);
    float xs[2];
    const int at[2] = {r.lo, r.hi};
    for (int s = 0; s < 2; ++s) {
      const long long row = s_pairs[at[s]] & 0xffffffffLL;
      xs[s] = wvalid[row * w + w - 1] ? vals[row * w + w - 1] : FLT_MAX;
    }
    out[0] = n > 0 ? interpolate(xs[0], xs[1], r.frac) : 0.f;
  }
}

__global__ void detector_rows_kernel(const float* __restrict__ vals,
                                     const float* __restrict__ bts,
                                     const uint8_t* __restrict__ wvalid,
                                     const float* __restrict__ peer, int64_t e, int64_t w,
                                     float a_q, float a_margin, float q, float hist_margin,
                                     float peer_margin, float min_bytes, float min_flush,
                                     uint8_t* __restrict__ flag, float* __restrict__ ratio,
                                     uint8_t* __restrict__ suspect) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (r >= e) return;
  const float* v = vals + r * w;
  const float* bt = bts + r * w;
  const uint8_t* ok = wvalid + r * w;
  const int m = static_cast<int>(w) - 1;

  float raw[kMaxWindows], nrm[kMaxWindows];
  int32_t key[kMaxWindows];
  int pos[kMaxWindows];
  int n = 0;
  for (int i = 0; i < m; ++i) {
    const bool vi = ok[i] != 0;
    n += vi;
    raw[i] = vi ? v[i] : FLT_MAX;
    nrm[i] = vi ? __fdiv_rn(v[i], max_nan(bt[i], kEps)) : FLT_MAX;
  }
  const float latest = v[m];
  const bool scorable = ok[m] != 0 && n > 0;

  // Metric anomaly and the raw slow-broker percentile share one ranking.
  for (int i = 0; i < m; ++i) key[i] = order_key(raw[i]);
  positions(key, m, pos);
  const float a_thr = __fmul_rn(select_percentile(raw, pos, m, n, rank_of(n, a_q)), a_margin);
  const float raw_hist = select_percentile(raw, pos, m, n, rank_of(n, q));
  for (int i = 0; i < m; ++i) key[i] = order_key(nrm[i]);
  positions(key, m, pos);
  const float norm_hist = select_percentile(nrm, pos, m, n, rank_of(n, q));

  flag[r] = scorable && latest > a_thr && latest > 0.f;
  ratio[r] = __fdiv_rn(latest, max_nan(a_thr, kEps));

  const float b_last = max_nan(bt[m], kEps);
  const float norm_last = __fdiv_rn(latest, b_last);
  const bool own_slow = latest > __fmul_rn(raw_hist, hist_margin) &&
                        norm_last > __fmul_rn(norm_hist, hist_margin);
  const bool floors = b_last >= min_bytes && latest >= min_flush;
  const float anchor = peer[0];
  const bool peer_slow = anchor > 0.f && latest > __fmul_rn(anchor, peer_margin);
  suspect[r] = scorable && floors && own_slow && peer_slow;
}

}  // namespace

extern "C" int cc_detector_peer(const float* vals, const uint8_t* wvalid, int64_t e,
                                int64_t w, float q, float* out, cudaStream_t stream) {
  if (e <= 0) return 0;
  if (e > kMaxPeers || w < 2) return static_cast<int>(cudaErrorInvalidValue);
  int64_t p2 = 2;
  while (p2 < e) p2 <<= 1;
  const size_t smem = static_cast<size_t>(p2) * sizeof(long long);
  cudaError_t rc = cudaFuncSetAttribute(detector_peer_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  detector_peer_kernel<<<1, kPeerThreads, smem, stream>>>(vals, wvalid, e, w, p2, q, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_detector_rows(const float* vals, const float* bts, const uint8_t* wvalid,
                                const float* peer, int64_t e, int64_t w, float a_q,
                                float a_margin, float q, float hist_margin, float peer_margin,
                                float min_bytes, float min_flush, uint8_t* flag, float* ratio,
                                uint8_t* suspect, cudaStream_t stream) {
  if (e <= 0) return 0;
  if (w < 2 || w > kMaxWindows) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((e + kRowThreads - 1) / kRowThreads);
  detector_rows_kernel<<<blocks, kRowThreads, 0, stream>>>(
      vals, bts, wvalid, peer, e, w, a_q, a_margin, q, hist_margin, peer_margin, min_bytes,
      min_flush, flag, ratio, suspect);
  return static_cast<int>(cudaGetLastError());
}
