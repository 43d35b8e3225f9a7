// K15 — the cross-shard combine of the broker aggregates of a search mesh
// whose model is sharded along the replica axis.
//
// cc_shard_combine replaces the psum that XLA inserts into the JAX
// package's sharded programs (cruise_control_tpu/parallel/mesh.py:16-20,69:
// under ``shard_model_replica_axis`` every segment reduction onto the broker
// axis lowers to a local scatter-add per device followed by a psum).  In the
// port each rank runs K1 (or ``segment_sum``) over its own replica rows, the
// ranks' partials are all-gathered by torch.distributed
// (parallel/collectives.py) into
//   fparts f32[n, B, Cf] — the float aggregates (K1's four resource loads,
//                          potential NW-out and leader bytes-in: Cf = 6; or
//                          segment_sum's C columns),
//   iparts i32[n, B, Ci] — the integer counts (replicas and leaders: Ci = 2;
//                          Ci = 0 and a null pointer when there are none),
// and this kernel sums them over the ranks:
//   fout f32[B, Cf] = ((p0 + p1) + p2) + ...  in rank order, __fadd_rn;
//   iout i32[B, Ci] = the exact sum (two's-complement wrap, as torch's).
// One thread per output element.  The float order is fixed, so the result is
// run-to-run identical and safe to replay; with n = 1 the output is the input
// bit for bit (a one-rank mesh equals the unsharded run).
//
// Bound: bytes — n * B * (Cf + Ci) * 4 read and B * (Cf + Ci) * 4 written
// (about 19 KB at B = 200, n = 2); a handful of adds per element.  Each
// thread reads its n partials with a stride of B * C elements, so a warp's
// loads stay coalesced for every rank.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void shard_combine_kernel(const float* __restrict__ fparts,
                                     const int32_t* __restrict__ iparts, int64_t n,
                                     int64_t nf, int64_t ni, float* __restrict__ fout,
                                     int32_t* __restrict__ iout) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < nf) {
    float acc = fparts[t];
    for (int64_t r = 1; r < n; ++r) acc = __fadd_rn(acc, fparts[r * nf + t]);
    fout[t] = acc;
  } else if (t < nf + ni) {
    const int64_t u = t - nf;
    uint32_t acc = static_cast<uint32_t>(iparts[u]);
    for (int64_t r = 1; r < n; ++r) acc += static_cast<uint32_t>(iparts[r * ni + u]);
    iout[u] = static_cast<int32_t>(acc);
  }
}

}  // namespace

// ``nf`` = B * Cf and ``ni`` = B * Ci elements of one rank's partials.
extern "C" int cc_shard_combine(const float* fparts, const int32_t* iparts, int64_t n,
                                int64_t nf, int64_t ni, float* fout, int32_t* iout,
                                cudaStream_t stream) {
  if (n < 1 || nf < 0 || ni < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = nf + ni;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  shard_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      fparts, iparts, n, nf, ni, fout, iout);
  return static_cast<int>(cudaGetLastError());
}
