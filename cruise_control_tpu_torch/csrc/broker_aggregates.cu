// K1 — per-broker aggregates of the replica axis — and segment_sum, the
// same masked per-segment sums for any f32[N, C] rows, each over a
// per-segment row index built by hand.
//
// cc_broker_aggregates replaces cruise_control_tpu/ops/segment.py:22-42
// (masked_segment_sum / masked_segment_count) as reached through
// analyzer/state.py:37 BrokerArrays.from_model -> model/tensor_model.py:
// 116-162 (broker_load, potential_leadership_load, broker_replica_counts,
// broker_leader_counts, broker_leader_bytes_in): five masked scatter-adds
// of replica rows into brokers, run at every optimizer step and every
// satisfied check.  cc_segment_sum replaces the float scatter-adds of the
// selection's per-broker round sums (cruise_control_tpu/analyzer/
// optimizer.py:663-668), of tensor_model.py:170 disk_load and of the disk
// goals' per-broker sums (goals/kernels.py:100,163-167).
//
// Bound on the card: bytes, and for a long segment the latency of its
// chain of adds.  K1 reads R * 38 bytes (broker id, two flags, two f32[4]
// load rows) and writes B * 32; segment_sum reads N * 5 bytes of ids and
// flags plus 4 C bytes a kept row and writes S * 4 C.  At the 200-broker
// rung that is ~4 MB for K1, about a microsecond at 3.35 TB/s: a launch
// costs more than the bytes.
//
// The float sums must be the plain version's bits: its index_add_ on the
// CPU (and the JAX package's scatter-add) adds each segment's rows one
// after the other in increasing row index, from 0, and a broker's band edge
// can fall between two roundings (the mid rung's default goal order parted
// the card from the CPU at CpuUsageDistributionGoal when K1 summed in its
// own order).  So every segment's sum is one serial chain of __fadd_rn in
// row order, with no float atomics: the CPU's bits, the same on every run
// and in every CUDA-graph replay.
//
// Design.  cc_segment_row_index groups the kept rows by segment, a stable
// counting sort keyed on the segment id (no sort of wider keys, no
// library call), in three launches with no host sync and no allocation
// that depends on the data, so the build replays inside a captured graph:
//   (a) count: a block of W warps (W = 8 unless S is too large for its
//       shared memory) takes W * T consecutive rows, each warp T of them
//       in steps of 32 (T = 128, or 256 where S * blocks would pass 2**19,
//       as at 4,000 disks: the wrapper picks it); __match_any_sync groups a step's equal
//       ids and the group's lowest lane adds __popc(group) to the warp's
//       histogram in shared memory; the block writes its per-segment total
//       to btot[s][block];
//   (b) scan: a warp per segment turns btot[s][*] into exclusive prefixes
//       over the blocks and writes the segment's total;
//   (c) scatter: each block scans the totals into the segment offsets,
//       counts its warps again, turns the histograms into per-(warp,
//       segment) cursors (offset + earlier blocks + earlier warps), and
//       each warp walks its rows again in row order: a row's slot is its
//       cursor plus its rank among the step's equal ids, and the group's
//       leader advances the cursor.  rows[] then holds each segment's kept
//       rows in increasing row order; the slots past the last kept row
//       hold -1.
// With a permutation perm, row i's id is seg[perm[i]], and a null mask
// keeps every row: K3 (prefix_cut.cu) groups its score-sorted rows so, up
// to 4,096 segments.
// The work is N + S * N / (W T) for the build, not S * N.
//
// The walks (broker_aggregates_kernel, segment_sum_kernel): one warp per
// segment over its index rows, 32 P rows at a time (P = 4 for K1; 8, 4 or
// 2 for segment_sum's 1, up to 8, up to 16 channels): each lane loads P
// rows' raw values into registers two chunks ahead of the add (their row
// ids three chunks ahead) and stages their columns in shared memory; then
// lane c adds column c of the staged rows in order.  K1's six columns are load[0..3],
// potential NW_OUT and leaders' NW_IN; its counts are the segment's
// length and a ballot of the leader flags.  A segment's chain is serial:
// a segment of L rows costs at least L dependent adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The per-segment row index
// ---------------------------------------------------------------------------

constexpr int kScanWarps = 8;
constexpr int kMaxSmem = 232448;            // shared memory a block can use
constexpr int kStaticSmem = 1024;           // kept for the scan's static buffer
constexpr int kDefaultSmem = 48 * 1024;     // dynamic shared memory without opting in

// A warp's 32 Steps keys: row row0 + 32 j + lane in step j; -1 for a row
// that is masked, out of range or past n, or whose id lies outside [0, S).
// Row i's id is seg[i], or seg[perm[i]] where a permutation is given (K3
// groups its rows in score order); a null mask keeps every row.
template <int Steps>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ seg,
                                          const uint8_t* __restrict__ mask,
                                          const int64_t* __restrict__ perm, int64_t n,
                                          int num_segments, int64_t row0,
                                          int (&key)[Steps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < Steps; ++j) {
    const int64_t i = row0 + 32 * j + lane;
    const bool in = i < n;
    const bool kept = in && (mask == nullptr || mask[i]);
    const int k = in ? seg[perm == nullptr ? i : perm[i]] : -1;
    key[j] = kept && k >= 0 && k < num_segments ? k : -1;
  }
}

// Adds the warp's keys into its histogram ``hist[S]``: in each step the
// lowest lane of each group of equal keys adds the group's size.
template <int Steps>
__device__ __forceinline__ void count_keys(const int (&key)[Steps], int32_t* hist) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < Steps; ++j) {
    const unsigned peers = __match_any_sync(kFull, key[j]);
    if (key[j] >= 0 && lane == __ffs(peers) - 1) hist[key[j]] += __popc(peers);
    __syncwarp();
  }
}

// out[i] = in[0] + ... + in[i - 1] for i <= n, over the whole block; in is
// device memory, out shared.  Synchronises the block.
__device__ void block_exclusive_scan(const int32_t* __restrict__ in, int32_t* out, int n) {
  __shared__ int32_t warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, warps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    int v = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    if (lane < warps) warp_sums[lane] = v;
  }
  __syncthreads();
  int run = inc - sum + (w > 0 ? warp_sums[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += in[i];
  }
  if (t == 0) out[n] = warp_sums[warps - 1];
  __syncthreads();
}

// (a) Block b's count of each segment: btot[s * NB + b].
template <int Steps>
__global__ void index_count_kernel(const int32_t* __restrict__ seg,
                                   const uint8_t* __restrict__ mask,
                                   const int64_t* __restrict__ perm, int64_t n,
                                   int num_segments, int32_t* __restrict__ btot) {
  extern __shared__ int32_t s_hist[];  // [warps][S]
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5, S = num_segments;
  int key[Steps];
  load_keys(seg, mask, perm, n, S,
            (static_cast<int64_t>(blockIdx.x) * warps + w) * 32 * Steps, key);
  for (int i = threadIdx.x; i < warps * S; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  count_keys(key, s_hist + w * S);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int total = 0;
    for (int q = 0; q < warps; ++q) total += s_hist[q * S + s];
    btot[static_cast<int64_t>(s) * gridDim.x + blockIdx.x] = total;
  }
}

// (b) A warp per segment: btot[s][*] becomes its exclusive prefix over the
// blocks, tot[s] the segment's count.
__global__ void index_scan_kernel(int32_t* __restrict__ btot, int num_segments,
                                  int num_blocks, int32_t* __restrict__ tot) {
  const int s = blockIdx.x * kScanWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (s >= num_segments) return;
  int32_t* row = btot + static_cast<int64_t>(s) * num_blocks;
  int run = 0;
  for (int base = 0; base < num_blocks; base += 32) {
    const int x = base + lane < num_blocks ? row[base + lane] : 0;
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    if (base + lane < num_blocks) row[base + lane] = run + inc - x;
    run += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) tot[s] = run;
}

// (c) The offsets and each kept row's slot.
template <int Steps>
__global__ void index_scatter_kernel(const int32_t* __restrict__ seg,
                                     const uint8_t* __restrict__ mask,
                                     const int64_t* __restrict__ perm, int64_t n,
                                     int num_segments, const int32_t* __restrict__ btot,
                                     const int32_t* __restrict__ tot,
                                     int32_t* __restrict__ offsets,
                                     int32_t* __restrict__ rows) {
  extern __shared__ int32_t s_hist[];  // [warps][S], then the offsets [S + 1]
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = num_segments;
  int32_t* s_off = s_hist + warps * S;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * warps + w) * 32 * Steps;
  int key[Steps];
  load_keys(seg, mask, perm, n, S, row0, key);
  for (int i = threadIdx.x; i < warps * S; i += blockDim.x) s_hist[i] = 0;
  block_exclusive_scan(tot, s_off, S);
  count_keys(key, s_hist + w * S);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int run = s_off[s] + btot[static_cast<int64_t>(s) * gridDim.x + blockIdx.x];
    for (int q = 0; q < warps; ++q) {
      const int c = s_hist[q * S + s];
      s_hist[q * S + s] = run;
      run += c;
    }
  }
  __syncthreads();
  int32_t* cursor = s_hist + w * S;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < Steps; ++j) {
    const int k = key[j];
    const unsigned peers = __match_any_sync(kFull, k);
    if (k >= 0)
      rows[cursor[k] + __popc(peers & below)] = static_cast<int32_t>(row0 + 32 * j + lane);
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) cursor[k] += __popc(peers);
    __syncwarp();
  }
  if (blockIdx.x == 0)
    for (int s = threadIdx.x; s <= S; s += blockDim.x) offsets[s] = s_off[s];
  const int total = s_off[S];
  const int64_t tile = static_cast<int64_t>(warps) * 32 * Steps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t end = first + tile < n ? first + tile : n;
  for (int64_t i = first + threadIdx.x; i < end; i += blockDim.x)
    if (i >= total) rows[i] = -1;
}

template <int Steps>
int build_index(const int32_t* seg, const uint8_t* mask, const int64_t* perm, int64_t n,
                int S, int warps, int32_t* offsets, int32_t* rows, int32_t* scratch,
                cudaStream_t stream) {
  const int64_t tile = static_cast<int64_t>(warps) * 32 * Steps;
  const int nb = static_cast<int>((n + tile - 1) / tile);
  int32_t* btot = scratch;                              // [S][nb]
  int32_t* tot = scratch + static_cast<int64_t>(S) * nb;  // [S]
  const size_t count_smem = static_cast<size_t>(warps) * S * sizeof(int32_t);
  const size_t scatter_smem = count_smem + (S + 1) * sizeof(int32_t);
  if (scatter_smem + kStaticSmem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // Past 48 KB a kernel takes dynamic shared memory only after opting in:
  // each launch that needs it sets the limit for both kernels (no stream
  // work; 4,000 segments take 144 KB, the main path's 200 under 8 KB).
  if (scatter_smem + kStaticSmem > static_cast<size_t>(kDefaultSmem)) {
    cudaError_t rc = cudaFuncSetAttribute(index_count_kernel<Steps>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kMaxSmem - kStaticSmem);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(index_scatter_kernel<Steps>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmem - kStaticSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  index_count_kernel<Steps><<<nb, 32 * warps, count_smem, stream>>>(seg, mask, perm, n, S,
                                                                    btot);
  index_scan_kernel<<<(S + kScanWarps - 1) / kScanWarps, 32 * kScanWarps, 0, stream>>>(
      btot, S, nb, tot);
  index_scatter_kernel<Steps><<<nb, 32 * warps, scatter_smem, stream>>>(
      seg, mask, perm, n, S, btot, tot, offsets, rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The walks: a warp per segment, its index rows in order
// ---------------------------------------------------------------------------

constexpr int kWalkWarps = 2;  // warps (segments) a walk block: spread over the SMs
constexpr int kMaxChannels = 16;

// K1's rows: replica r's leader flag and both load rows as loaded, and its
// six columns: load[0..3] by the flag, potential NW_OUT, and NW_IN when it
// leads (Resource.NW_IN = 1, NW_OUT = 2).  Four rows a lane per chunk;
// each load row is one float4 (the wrapper checks the 16-byte alignment).
struct K1Rows {
  static constexpr int kCols = 6;
  static constexpr int kPer = 4;
  struct Raw {
    float4 ll, lf;
    bool lead;
  };
  const uint8_t* __restrict__ is_leader;
  const float* __restrict__ load_leader;    // [R, 4]
  const float* __restrict__ load_follower;  // [R, 4]
  __device__ __forceinline__ void fetch(int r, Raw& x) const {
    x.lead = false;
    x.ll = x.lf = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < 0) return;
    x.lead = is_leader[r] != 0;
    const int64_t at = 4 * static_cast<int64_t>(r);
    x.ll = *reinterpret_cast<const float4*>(load_leader + at);
    x.lf = *reinterpret_cast<const float4*>(load_follower + at);
  }
  __device__ __forceinline__ float column(const Raw& x, int c) const {
    const float4& v = x.lead ? x.ll : x.lf;
    switch (c) {
      case 0: return v.x;
      case 1: return v.y;
      case 2: return v.z;
      case 3: return v.w;
      case 4: return x.ll.z;
      default: return x.lead ? x.ll.y : 0.f;
    }
  }
};

// segment_sum's rows: row r of values[N, channels], channels <= Cols.
// Per * Cols registers a chunk: wider rows take fewer rows a lane.
template <int Cols>
struct SumRows {
  static constexpr int kCols = Cols;
  static constexpr int kPer = Cols == 1 ? 8 : Cols <= 8 ? 4 : 2;
  struct Raw {
    float v[Cols];
    bool lead;
  };
  const float* __restrict__ values;
  int channels;
  __device__ __forceinline__ void fetch(int r, Raw& x) const {
    x.lead = false;
#pragma unroll
    for (int c = 0; c < Cols; ++c)
      x.v[c] = (r >= 0 && c < channels) ? values[static_cast<int64_t>(r) * channels + c] : 0.f;
  }
  __device__ __forceinline__ float column(const Raw& x, int c) const { return x.v[c]; }
};

// The row ids of one chunk: rows at + 32 q + lane, -1 past ``end``.
template <int Per>
__device__ __forceinline__ void row_ids(const int32_t* __restrict__ rows, int at, int end,
                                        int (&rid)[Per]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < Per; ++q) {
    const int i = at + 32 * q + lane;
    rid[q] = i < end ? rows[i] : -1;
  }
}

// Lane c < cols: column c of rows[beg..end) added in order from 0, with
// __fadd_rn; ``leaders``: how many of the rows lead (every lane).  The warp
// takes 32 Per rows a chunk: their raw values load two chunks ahead (their
// row ids three), then each lane writes its rows' columns to ``stage`` and
// lane c adds column c of the chunk in row order.
template <class Rows>
__device__ float walk_segment(const Rows& rw, const int32_t* __restrict__ rows, int beg,
                              int end, int cols, float (*stage)[32 * Rows::kPer + 1],
                              int& leaders) {
  constexpr int Per = Rows::kPer, C = Rows::kCols, kChunk = 32 * Per;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  leaders = 0;
  int rid[Per], rid_next[Per];
  typename Rows::Raw cur[Per], nxt[Per], nxt2[Per];
  row_ids<Per>(rows, beg, end, rid);
#pragma unroll
  for (int q = 0; q < Per; ++q) rw.fetch(rid[q], cur[q]);
  row_ids<Per>(rows, beg + kChunk, end, rid);
#pragma unroll
  for (int q = 0; q < Per; ++q) rw.fetch(rid[q], nxt[q]);
  row_ids<Per>(rows, beg + 2 * kChunk, end, rid);
  for (int base = beg; base < end; base += kChunk) {
    row_ids<Per>(rows, base + 3 * kChunk, end, rid_next);
#pragma unroll
    for (int q = 0; q < Per; ++q) rw.fetch(rid[q], nxt2[q]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Per; ++q) {
      leaders += __popc(__ballot_sync(kFull, cur[q].lead));
#pragma unroll
      for (int c = 0; c < C; ++c) stage[c][32 * q + lane] = rw.column(cur[q], c);
    }
    __syncwarp();
    const int count = min(kChunk, end - base);
    if (lane < cols) {
      if (count == kChunk) {
        // 32 staged values into registers at a time, then their adds.
#pragma unroll
        for (int j0 = 0; j0 < kChunk; j0 += 32) {
          float x[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) x[j] = stage[lane][j0 + j];
#pragma unroll
          for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, x[j]);
        }
      } else {
#pragma unroll 8
        for (int j = 0; j < count; ++j) acc = __fadd_rn(acc, stage[lane][j]);
      }
    }
#pragma unroll
    for (int q = 0; q < Per; ++q) {
      cur[q] = nxt[q];
      nxt[q] = nxt2[q];
      rid[q] = rid_next[q];
    }
  }
  return acc;
}

__global__ void broker_aggregates_kernel(const int32_t* __restrict__ offsets,
                                         const int32_t* __restrict__ rows,
                                         K1Rows rw, int num_brokers,
                                         float* __restrict__ load,  // [B, 4]
                                         int32_t* __restrict__ replica_count,
                                         int32_t* __restrict__ leader_count,
                                         float* __restrict__ potential_nw_out,
                                         float* __restrict__ leader_bytes_in) {
  __shared__ float stage[kWalkWarps][K1Rows::kCols][32 * K1Rows::kPer + 1];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + w;
  if (b >= num_brokers) return;
  const int beg = offsets[b], end = offsets[b + 1];
  int leaders;
  const float acc = walk_segment(rw, rows, beg, end, K1Rows::kCols, stage[w], leaders);
  if (lane < 4) load[4 * b + lane] = acc;
  if (lane == 4) potential_nw_out[b] = acc;
  if (lane == 5) leader_bytes_in[b] = acc;
  if (lane == 0) {
    replica_count[b] = end - beg;
    leader_count[b] = leaders;
  }
}

template <int Cols>
__global__ void segment_sum_kernel(const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ rows, SumRows<Cols> rw,
                                   int num_segments, float* __restrict__ out) {  // [S, C]
  __shared__ float stage[kWalkWarps][Cols][32 * SumRows<Cols>::kPer + 1];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWalkWarps + w;
  if (s >= num_segments) return;
  int leaders;
  const float acc = walk_segment(rw, rows, offsets[s], offsets[s + 1], rw.channels, stage[w],
                                 leaders);
  if (lane < rw.channels) out[static_cast<int64_t>(s) * rw.channels + lane] = acc;
}

unsigned walk_blocks(int64_t segments) {
  return static_cast<unsigned>((segments + kWalkWarps - 1) / kWalkWarps);
}

template <int Cols>
int launch_segment_sum(const float* values, const int32_t* offsets, const int32_t* rows,
                       int channels, int64_t num_segments, float* out, cudaStream_t stream) {
  segment_sum_kernel<Cols><<<walk_blocks(num_segments), 32 * kWalkWarps, 0, stream>>>(
      offsets, rows, SumRows<Cols>{values, channels}, static_cast<int>(num_segments), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The row index of the kept rows (mask set, id in [0, S)) by segment:
// offsets[S + 1] and rows[n] (each segment's rows in increasing order, -1
// past offsets[S]).  The caller picks the tiling: ``warps`` (8, 4, 2 or 1)
// a build block and ``warp_rows`` (128 or 256) a warp, so that the warps'
// histograms fit a block's shared memory and S * blocks stays short;
// ``scratch`` holds S * ceil(n / (warps * warp_rows)) + S ints.
// The per-segment row index of rows 0..n-1 (ids seg[i], or seg[perm[i]]
// with a permutation; every row kept where mask is null).
extern "C" int cc_segment_row_index(const int32_t* seg, const uint8_t* mask,
                                    const int64_t* perm, int64_t n, int64_t num_segments,
                                    int64_t warps, int64_t warp_rows, int32_t* offsets,
                                    int32_t* rows, int32_t* scratch, cudaStream_t stream) {
  if (num_segments <= 0 || n <= 0 || n >= (int64_t{1} << 31) ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>(num_segments), w = static_cast<int>(warps);
  switch (warp_rows) {
    case 128: return build_index<4>(seg, mask, perm, n, S, w, offsets, rows, scratch, stream);
    case 256: return build_index<8>(seg, mask, perm, n, S, w, offsets, rows, scratch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cc_segment_sum(const float* values, const int32_t* offsets,
                              const int32_t* rows, int64_t channels, int64_t num_segments,
                              float* out, cudaStream_t stream) {
  if (num_segments <= 0) return 0;
  if (channels < 1 || channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(channels);
  if (c == 1) return launch_segment_sum<1>(values, offsets, rows, c, num_segments, out, stream);
  if (c <= 8) return launch_segment_sum<8>(values, offsets, rows, c, num_segments, out, stream);
  return launch_segment_sum<16>(values, offsets, rows, c, num_segments, out, stream);
}

extern "C" int cc_broker_aggregates(const int32_t* offsets, const int32_t* rows,
                                    const uint8_t* is_leader, const float* load_leader,
                                    const float* load_follower, float* load,
                                    int32_t* replica_count, int32_t* leader_count,
                                    float* potential_nw_out, float* leader_bytes_in,
                                    int64_t num_brokers, cudaStream_t stream) {
  if (num_brokers <= 0) return 0;
  broker_aggregates_kernel<<<walk_blocks(num_brokers), 32 * kWalkWarps, 0, stream>>>(
      offsets, rows, K1Rows{is_leader, load_leader, load_follower},
      static_cast<int>(num_brokers), load, replica_count, leader_count, potential_nw_out,
      leader_bytes_in);
  return static_cast<int>(cudaGetLastError());
}
